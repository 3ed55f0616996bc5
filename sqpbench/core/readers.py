"""The arithmetic of the metrics' readers (``metrics/<name>.py``), kept in
one place so that two cells' names of one quantity read it alike.  Each
takes a :class:`harness.Run` and returns a number, or None where the run
has nothing to read."""

from __future__ import annotations

from .yardstick import PEAKS, chol_bound_s, dense_solve_flops, peaks


def solves_per_s(run):
    """Lanes that end solved (status 0, 1, 6) over the whole window."""
    return sum(run.solved(r) for r in run.requests) / run.window_s


def solve_s(run):
    """The window over the requests completed in it."""
    return run.window_s / len(run.requests)


def setup_s(run):
    return run.setup_s


def sqp_iter_ms(run):
    """The window over the batched SQP iterations: each request counts its
    lane with the most iterations."""
    iters = sum(int(r.answer["iterations"].max()) for r in run.requests)
    return 1e3 * run.window_s / iters if iters else None


def ipm_trip_ms(run):
    """Host milliseconds per batched interior-point trip, both phases, over
    the window (the program's own counters)."""
    trips = run.counters.get("ipm_trips")
    return 1e3 * run.counters["ipm_seconds"] / trips if trips else None


def host_syncs_per_request(run):
    """Host syncs of the lane loops over the window's requests."""
    return run.counters["syncs"] / len(run.requests)


def device_idle_share(run):
    """Percent of the traced stretch in which no operation ran on the card."""
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def chol_tile_roofline(run):
    """Percent: the least time the card could take for the traced
    ``chol_tile`` launches, each at its own shape, over the device time of
    the kernels named ``chol_tile``."""
    t = run.trace
    if not t or not t["chol_shapes"] or run.device_kind not in PEAKS:
        return None
    spent = sum(s for name, s in t["device_ops"].items() if "chol_tile" in name)
    if spent <= 0:
        return None
    bound = sum(chol_bound_s(b, n, run.device_kind) for b, n in t["chol_shapes"])
    return 100.0 * bound / spent


def step_mfu(run):
    """Percent of the card's float64 peak: the useful FLOPs of the traced
    requests' solves (dense count, iterations summed over lanes) over the
    traced stretch."""
    t = run.trace
    if not t or not t["requests"] or run.device_kind not in PEAKS:
        return None
    cfg = run.cell.config
    flops = sum(
        dense_solve_flops(
            n=cfg["n"], m=cfg["m"], schur_rows=cfg.get("schur_rows", cfg["m"]),
            ir_steps=cfg["parameters"].get("kkt_ir_steps", 2),
            sqp_iterations=int(r.answer["iterations"].sum()),
            qp_iterations=int(r.answer["qp_iterations"].sum()),
        )
        for r in t["requests"]
    )
    return 100.0 * flops / t["window_s"] / peaks(run.device_kind)["fp64_tensor"]
