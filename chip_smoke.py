"""Smoke run of the PyTorch port (``sqpsolver_tpu_torch``) on one NVIDIA GPU.

Usage, from the repository root, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA::

    python3 chip_smoke.py            # build, check the kernel, run the slice
    python3 chip_smoke.py --profile out/profile_slice.json  # + a profiled run

Phases (any failure raises and the exit code is non-zero):

1. print the card (``nvidia-smi`` name and power limit);
2. build ``sqpsolver_tpu_torch/csrc/chol_tile.cu`` with ``nvcc`` for sm_90a;
3. hold the Cholesky kernel against its plain PyTorch version on the card
   at the slice's shapes (32x72x72 K, 32x96x96 capped Schur S), at
   256x128x128 and at small and odd sizes (3x1x1, 5x7x7, 32x33x33,
   32x127x127) that reach every width the kernel is compiled for and its
   ragged edge: max|dL| / max|L| <= 1e-5 and an exact-zero upper triangle;
   an indefinite tile must give a non-finite factor on that tile only.  At
   the first three shapes the kernel, the plain version and one library call
   that computes the same function (``torch.linalg.cholesky_ex``, a yardstick
   that the package's kernel path never calls) are timed with CUDA events, and
   the least time the card could take (``bound_ms``) is computed from the
   shape;
4. run the slice -- batched ACOPF on MATPOWER case30 with 32 load scenarios,
   dense SQP-TR, mixed_ir factorizations through the kernel, float64 state --
   through ``make_batch_solver`` on ``cuda``; every lane must converge
   (status 0, 1 or 6) to within 1e-6 relative of the per-lane objective the
   JAX package reached on the same data
   (``sqpsolver_tpu_torch/data/anchor_case30_b32.json``), and the kernel's
   launch count over that run must be positive;
5. with ``--profile PATH``: one more slice run under ``torch.profiler``,
   printing the device time by kernel and the device's busy share of the wall
   time, and writing the summary as JSON to ``PATH``.

Standard output ends with these lines, in this order: the kernel's share of
its bound and its ratio to the library call at the slice's two shapes; the
kernels' JSON record ``{"kernels": [...]}``; the card's name and power limit
as ``nvidia-smi`` gives them; and last ``{"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": ...}}``.  This script imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1.0e-5  # max|dL| / max|L|, float32 factors of n <= 128
OBJ_RTOL = 1.0e-6  # per-lane objective against the JAX anchor
SLICE_SHAPES = ((32, 72), (32, 96))  # K and the capped Schur S of case30 b32
TIMED = SLICE_SHAPES + ((256, 128),)
SHAPES = TIMED + ((3, 1), (5, 7), (32, 33), (32, 127))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67.0e12  # H100 SXM data sheet, float32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def spd_batch(torch, rng, batch, n):
    """Seeded SPD float32 tiles, equilibrated to a unit diagonal like the
    KKT matrices the solver factors."""
    import numpy as np

    G = rng.standard_normal((batch, n, n))
    M = G @ G.transpose(0, 2, 1) / n + 0.05 * np.eye(n)
    d = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    M = M * d[:, :, None] * d[:, None, :]
    return torch.tensor(M, dtype=torch.float32, device="cuda")


def cuda_ms(torch, fn, arg, reps=30, inner=1):
    """Median milliseconds of one ``fn(arg)`` over ``reps`` windows of
    ``inner`` calls each (CUDA events), after 3 warm-up calls.

    With ``inner == 1`` a window is one call as a caller makes it, host
    enqueue time included: right for the plain version, itself a host loop of
    launches.  With ``inner > 1`` the calls of a window are enqueued while the
    card is still busy with a large matrix product enqueued just before the
    first event, so they run back to back and the window holds device time
    only, as a profile counts it.  A window in which the card caught up
    with the host all the same (``fn`` waits for the card, or enqueues
    slowly) holds host time too; their number is logged."""
    for _ in range(3):
        fn(arg)
    plug = torch.empty((4096, 4096), device="cuda").normal_() if inner > 1 else None
    times = []
    drained = 0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if plug is not None:
            for _ in range(3):
                torch.mm(plug, plug)
        start.record()
        for _ in range(inner):
            fn(arg)
        stop.record()
        drained += plug is not None and start.query()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    if drained:
        log(f"cuda_ms: {getattr(fn, '__name__', fn)}: the card drained its queue in "
            f"{drained} of {reps} windows; the time holds host time too")
    return statistics.median(times)


def chol_bound(batch, n):
    """Least milliseconds the card could take to factor (batch, n, n) float32
    tiles, and what binds: every input byte read once and every output byte
    written once over the memory rate, against batch * n^3 / 3 operations over
    the float32 rate."""
    bytes_ms = 2 * batch * n * n * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = batch * n**3 / 3 / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def check_kernel(torch, chol_blocked, card):
    """Phase 3: kernel against plain, on the card.  Returns the kernel record."""
    import numpy as np

    chol_tile, plain = chol_blocked.chol_tile, chol_blocked.chol_tile_plain
    rng = np.random.default_rng(20240901)
    worst = 0.0
    identical = True
    for batch, n in SHAPES:
        M = spd_batch(torch, rng, batch, n)
        L = chol_tile(M)
        Lp = plain(M)
        torch.cuda.synchronize()
        err = (L - Lp).abs().max().item()
        rel = err / Lp.abs().max().item()
        upper = torch.triu(L, diagonal=1).abs().max().item()
        log(f"kernel ({batch},{n},{n}): max|dL| {err:.3e}, max|dL|/max|L| "
            f"{rel:.3e} (tol {KERNEL_TOL:g}), max|upper| {upper}")
        if not (torch.isfinite(L).all().item() and rel <= KERNEL_TOL and upper == 0.0):
            raise AssertionError(f"kernel disagrees with plain at ({batch},{n},{n})")
        worst = max(worst, err)
        identical = identical and torch.equal(L, Lp)
    log(f"kernel bit-identical to plain at every shape: {identical}")
    M = spd_batch(torch, rng, 4, 96)
    M[1, 5, 5] = -1.0e3
    L = chol_tile(M)
    bad = ~torch.isfinite(L)
    if not bad[1].any().item() or bad[[0, 2, 3]].any().item():
        raise AssertionError("indefinite tile did not give a non-finite factor")
    log("kernel (4,96,96) with one indefinite tile: non-finite factor on that tile only")
    timings = {}
    for batch, n in TIMED:
        M = spd_batch(torch, rng, batch, n)
        ms = cuda_ms(torch, chol_tile, M, inner=20)
        library_ms = cuda_ms(torch, torch.linalg.cholesky_ex, M, inner=20)
        plain_ms = cuda_ms(torch, plain, M, reps=10)
        bound_ms, bound_by = chol_bound(batch, n)
        timings[f"{batch}x{n}x{n}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"time ({batch},{n},{n}) on {card}: kernel {ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}), library cholesky_ex "
            f"{library_ms:.4f} ms, plain {plain_ms:.4f} ms")
    main = timings["32x96x96"]
    return {
        "name": "chol_tile",
        "route": "cuda",
        "source": "sqpsolver_tpu_torch/csrc/chol_tile.cu",
        "replaces": "sqpsolver_tpu/ops/chol_blocked.py:116",
        "launches": None,
        "max_abs_err": worst,
        **main,
        "bit_identical": identical,
        "timings": timings,
    }


def run_slice(torch, record):
    """Phase 4: the case30 b32 slice through the port's public entry points."""
    import numpy as np

    from sqpsolver_tpu_torch import Parameters, batch_data, make_batch_solver
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu_torch.models.matpower import load_case
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    with open(os.path.join(ROOT, "sqpsolver_tpu_torch", "data", "anchor_case30_b32.json")) as fh:
        anchor = json.load(fh)
    case = load_case(anchor["case"])
    nlp = acopf_polar(case)
    batch = anchor["batch"]
    theta = load_scenarios(case, batch, seed=anchor["seed"], spread=anchor["spread"])
    params = Parameters(**anchor["params"])
    log(f"slice: {case.name} n={nlp.n} m={nlp.m} batch={batch} params={anchor['params']}")
    solver = make_batch_solver(nlp, params)

    def solve():
        data = batch_data(nlp, batch, theta=theta)  # on the card by default
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver(data)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, first = solve()
    log(f"slice first run (CUDA/cuBLAS start-up included): {first:.3f} s")
    chol_tile.launches = 0
    syncs0 = any_lane.syncs
    out, wall = solve()
    launches = chol_tile.launches
    syncs = any_lane.syncs - syncs0
    record["launches"] = launches

    status = out.status.cpu().numpy()
    obj = out.obj_val.cpu().numpy()
    ref = np.asarray(anchor["lanes"]["obj"])
    rel = np.abs(obj - ref) / np.abs(ref)
    iters = int(out.iterations.sum().item())
    trips = int(out.qp_iters_total.sum().item())
    n_ok = int(np.isin(status, [0, 1, 6]).sum())
    log(f"slice: wall {wall:.4f} s, {iters} SQP iterations "
        f"({iters / wall:.2f} SQP-iter/s), {n_ok}/{batch} solved "
        f"({n_ok / wall:.3f} solves/s), {trips} IPM trips, {syncs} host syncs, "
        f"{launches} chol_tile launches")
    log(f"slice: JAX anchor {anchor['totals']['iterations']} iterations, "
        f"{anchor['totals']['qp_trips']} IPM trips "
        f"({anchor['reference']['platform']}, kkt_backend="
        f"{anchor['reference']['kkt_backend']})")
    log(f"slice: per-lane objective rel. diff to the anchor: max {rel.max():.3e} "
        f"(tol {OBJ_RTOL:g}); statuses {sorted(set(status.tolist()))}")
    if out.x.shape != (batch, nlp.n) or not torch.isfinite(out.x).all().item():
        raise AssertionError("slice: x is not finite of shape (batch, n)")
    if n_ok != batch:
        raise AssertionError(f"slice: only {n_ok}/{batch} lanes converged: {status}")
    if not (rel <= OBJ_RTOL).all():
        raise AssertionError(f"slice: lanes off the anchor: {np.nonzero(rel > OBJ_RTOL)[0]}")
    if launches <= 0:
        raise AssertionError("slice: the Cholesky kernel was never launched")
    return solve, wall, trips


def _kernel_family(name):
    low = name.lower()
    if "chol_tile" in low:
        return "chol_tile (hand kernel)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "gemm" in low or "gemv" in low or "dot_kernel" in low or "cutlass" in low:
        return "cuBLAS matmul"
    if "reduce" in low:
        return "reductions"
    if "sort" in low or "scatter" in low or "gather" in low or "index" in low:
        return "sort/gather/scatter"
    return "elementwise/other"


def profile_slice(torch, solve, wall_plain, trips, out_path):
    """Phase 5: one more slice run under torch.profiler; the summary goes to
    ``out_path`` as JSON."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_prof = solve()
    by_name, by_family = {}, {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        n_kernels += 1
        cnt, tot = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (cnt + 1, tot + us)
        cnt, tot = by_family.get(_kernel_family(ev.name), (0, 0.0))
        by_family[_kernel_family(ev.name)] = (cnt + 1, tot + us)
    busy_s = sum(t for _, t in by_name.values()) / 1e6
    log(f"profile: wall {wall_prof:.3f} s under the profiler ({wall_plain:.3f} s "
        f"without); device busy {busy_s:.4f} s = {busy_s / wall_plain:.1%} of the "
        f"unprofiled wall; {n_kernels} device events ({n_kernels / max(trips, 1):.1f} "
        f"per lane-IPM-trip)")
    for fam, (cnt, tot) in sorted(by_family.items(), key=lambda kv: -kv[1][1]):
        log(f"profile family: {fam:28s} {cnt:8d} events {tot / 1e3:10.3f} ms "
            f"({tot / 1e6 / busy_s:.1%} of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (cnt, tot) in top:
        log(f"profile kernel: {tot / 1e3:10.3f} ms {cnt:8d}x  {name[:110]}")
    hand = {k: v for k, v in by_name.items() if "chol_tile" in k.lower()}
    for name, (cnt, tot) in sorted(hand.items()):
        log(f"profile hand kernel: {tot / 1e3:10.3f} ms {cnt:8d}x  {name[-60:]}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump({
            "wall_s": wall_plain, "wall_profiled_s": wall_prof, "device_busy_s": busy_s,
            "device_events": n_kernels,
            "families": {k: {"count": c, "ms": t / 1e3} for k, (c, t) in by_family.items()},
            "top_kernels": [{"name": k, "count": c, "ms": t / 1e3} for k, (c, t) in top],
            "hand_kernels": [{"name": k, "count": c, "ms": t / 1e3} for k, (c, t) in hand.items()],
        }, fh, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument(
        "--profile", metavar="PATH",
        help="profile one more slice run and write its summary as JSON to PATH",
    )
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    sys.path.insert(0, ROOT)
    from sqpsolver_tpu_torch.ops import _build, chol_blocked

    info = _build.build("chol_tile")
    log(f"build: {os.path.relpath(info.path, ROOT)} in {info.seconds:.2f} s"
        + ("" if info.seconds else " (already built from this source)"))
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"build: {line.strip()}")

    record = check_kernel(torch, chol_blocked, card)
    solve, wall, trips = run_slice(torch, record)
    if args.profile:
        profile_slice(torch, solve, wall, trips, args.profile)
    for batch, n in SLICE_SHAPES:
        t = record["timings"][f"{batch}x{n}x{n}"]
        log(f"chol_tile ({batch},{n},{n}) on {card}: {t['bound_ms'] / t['ms']:.2%} of "
            f"its bound, {t['ms'] / t['library_ms']:.3f} of the library call's time")
    log(json.dumps({"kernels": [record]}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
