"""Instance-batched solves (torch port of ``parallel/batch.py``).

The port's solver is batch-first already: one host-driven SQP program
advances B independent instances in lockstep, with per-instance status, FR
and TR state as masked arithmetic; the batch finishes when every instance
has terminated.  :func:`make_chunked_batch_solver` advances the same state
in host-controlled rounds through a slab of lanes (a work queue) and can
re-solve the lanes whose float32-factorized QPs stalled with the float64
rescue phase switched on.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .._lanes import gather_lanes, scatter_lanes
from ..algorithms.sqp_tr import SqpResult, make_solver
from ..convert import theta_to_torch
from ..nlp import NLP, NLPData, resolve_device
from ..parameters import Parameters
from ..status import Status


def batch_data(
    nlp: NLP,
    batch: int,
    *,
    theta=None,
    x0=None,
    dtype=torch.float64,
    device=None,
) -> NLPData:
    """Tile an NLP's data along a leading batch axis on ``device``.

    ``device=None`` is the CUDA card, and raises where there is none; the CPU
    is used only when asked for (``device="cpu"``).  The solver runs where
    the data lies.  ``theta`` (a dict of arrays with leading axis ``batch``)
    and/or ``x0`` (per-instance starts, (batch, n)) override the tiled
    defaults.
    """
    device = resolve_device(device)
    base = nlp.data(dtype=dtype, device=device)

    def tile(a):
        return a.expand((batch,) + tuple(a.shape)).clone()

    if theta is None:
        theta = None if base.theta is None else {k: tile(v) for k, v in base.theta.items()}
    else:
        theta = theta_to_torch(theta, device=device, dtype=dtype)
    x0_t = tile(base.x0) if x0 is None else torch.as_tensor(x0, dtype=dtype, device=device)
    return NLPData(
        x_l=tile(base.x_l),
        x_u=tile(base.x_u),
        g_l=tile(base.g_l),
        g_u=tile(base.g_u),
        x0=x0_t,
        theta=theta,
    )


def make_batch_solver(
    nlp: NLP, params: Parameters = Parameters()
) -> Callable[[NLPData], SqpResult]:
    """Batched solver: batched NLPData -> batched SqpResult, on the device
    the data lies on; SQP-TR or SQP-LS as ``params.algorithm`` says, and
    silent (no iteration log)."""
    from .. import make_solver as dispatch

    return dispatch(nlp, params, verbose=False)


def make_chunked_batch_solver(
    nlp: NLP,
    params: Parameters = Parameters(),
    *,
    chunk0: int = 1,
    max_chunk: int = 64,
    sub_batch: int = 0,
    log: Optional[Callable[[str], None]] = None,
    rescue_fallback: bool = False,
    _pass: str = "first",
) -> Callable[[NLPData], SqpResult]:
    """Batched solver advanced in host-controlled rounds of outer iterations.

    Each round advances a slab of lanes by ``min(chunk0, max_chunk)`` SQP
    iterations through the solver's ``run_until`` stage and costs one host
    sync (every lane's iteration count and done flag) on top of the solver's
    own.  The rounds are the cut points of a checkpoint or a lane repacking;
    the result is that of the monolithic solver, lane for lane.

    ``sub_batch``: slab width (0 = the whole batch).  With a slab the lanes
    form a WORK QUEUE: each round gathers the ``sub_batch`` least-advanced
    lanes still running (fewer when fewer are left: no padding lanes ride
    along), advances them and scatters their state back.  One straggler then
    costs a slab of its own width, not the whole batch's.  The round's
    iteration limit keys on the slab's own lanes.

    ``rescue_fallback``: two-pass execution for ``qp_rescue=False``.  Pass 1
    runs the float32-factorized program; lanes that end in
    ``Error_In_Step_Computation`` are then re-solved from cold, at their own
    count, by a lazily built twin with ``qp_rescue=True`` (the float64 IPM
    phase 2), and their results merged back.  Only the stalled lanes pay for
    float64 factorizations.

    ``solve.stats`` holds the last call's ``rounds`` (= host syncs of this
    loop), ``fallback_lanes`` and ``fallback_rounds``.  The process-wide
    counters on this function add up every call of every chunked solver:
    ``make_chunked_batch_solver.rounds`` (the twin's rounds included),
    ``fallback_lanes`` (lanes handed to a twin), ``fallback_rounds`` (the
    twins' rounds) and ``pass_seconds`` (host seconds of each pass, ``first``
    and ``fallback``, each from the call's start to the last host sync the
    pass makes; ``_pass`` names the pass a solver counts as, and the twin
    counts as ``fallback``).

    Left out of the JAX package's version, which sizes every device call
    against a 60 s execution limit of its TPU host and works around compiler
    faults at narrow widths: the wall-clock chunk controller
    (``target_chunk_seconds``), the micro-stepped rescue (``micro_trips``),
    the width floor of 4 with its duplicate-lane padding, the fixed fallback
    slab width, and the rule that pins rescue-enabled solves of n >= 160 to
    one iteration per call.  A CUDA stream has no such limit and the port
    compiles nothing per shape.
    """
    solver = make_solver(nlp, params.replace(OutputFlag=0))  # no iteration log
    max_iter = params.max_iter
    k = max(1, min(int(chunk0), int(max_chunk)))
    fallback: list = []

    def solve(data: NLPData) -> SqpResult:
        t0 = time.perf_counter()
        B = int(data.x0.shape[0])
        W = min(int(sub_batch), B) if sub_batch else B
        dev = data.x0.device
        st = solver.init_state(data)
        stats = dict(rounds=0, fallback_lanes=[], fallback_rounds=0)
        solve.stats = stats
        while True:
            # the round's one host sync
            flags = torch.stack([st.iter, st.done.to(st.iter.dtype)]).cpu().numpy()
            it, done = flags[0], flags[1].astype(bool)
            active = np.where(~done & (it <= max_iter))[0]
            if active.size == 0:
                t_end = time.perf_counter()
                break
            # work queue: the W least-advanced active lanes form the slab
            sel = np.sort(active[np.argsort(it[active], kind="stable")][:W])
            limit = min(int(it[sel].min()) + k - 1, max_iter)
            if log:
                log(f"chunked: -> limit {limit} (k={k}, {int(done.sum())}/{B} done, "
                    f"slab {sel.size})")
            if sel.size == B:
                st = solver.run_until(st, data, limit)
            else:
                idx = torch.as_tensor(sel, dtype=torch.int64, device=dev)
                slab = solver.run_until(gather_lanes(st, idx), gather_lanes(data, idx), limit)
                st = scatter_lanes(st, slab, idx)
            stats["rounds"] += 1
            make_chunked_batch_solver.rounds += 1
            if _pass == "fallback":
                make_chunked_batch_solver.fallback_rounds += 1
        res = solver.finalize(st, data)

        bad = np.empty(0, dtype=np.int64)
        if rescue_fallback and not params.qp_rescue:
            status = res.status.cpu().numpy()  # the first pass ends at this sync
            t_end = time.perf_counter()
            bad = np.where(status == int(Status.ERROR_IN_STEP_COMPUTATION))[0]
        make_chunked_batch_solver.pass_seconds[_pass] += t_end - t0
        if bad.size:
            if log:
                log(f"chunked: rescue fallback for {bad.size} lanes")
            if not fallback:
                fallback.append(make_chunked_batch_solver(
                    nlp, params.replace(qp_rescue=True),
                    chunk0=chunk0, max_chunk=max_chunk, sub_batch=sub_batch, log=log,
                    _pass="fallback",
                ))
            make_chunked_batch_solver.fallback_lanes += int(bad.size)
            idx = torch.as_tensor(bad, dtype=torch.int64, device=dev)
            res_bad = fallback[0](gather_lanes(data, idx))
            res = scatter_lanes(res, res_bad, idx)
            stats["fallback_lanes"] = bad.tolist()
            stats["fallback_rounds"] = fallback[0].stats["rounds"]
        return res

    solve.stats = dict(rounds=0, fallback_lanes=[], fallback_rounds=0)
    return solve


#: rounds (one host sync each) of every chunked solver so far
make_chunked_batch_solver.rounds = 0
#: host seconds of each pass so far: the first pass, and the rescue fallback
make_chunked_batch_solver.pass_seconds = {"first": 0.0, "fallback": 0.0}
#: lanes handed to the rescue fallback so far, and the fallback's rounds
make_chunked_batch_solver.fallback_lanes = 0
make_chunked_batch_solver.fallback_rounds = 0


def summarize_batch(raw: SqpResult) -> dict:
    """Host-side summary of a batched solve."""

    def host(t):
        return t.detach().cpu().numpy()

    status = host(raw.status)
    return {
        "batch": int(status.shape[0]),
        "n_success": int(np.isin(status, [0, 1, 6]).sum()),
        "n_infeasible": int((status == 2).sum()),
        "status_counts": {int(s): int((status == s).sum()) for s in np.unique(status)},
        "iterations_max": int(host(raw.iterations).max()),
        "iterations_mean": float(host(raw.iterations).mean()),
        "prim_infeas_max": float(host(raw.prim_infeas).max()),
        "obj_mean": float(host(raw.obj_val).mean()),
        "n_reject": int(host(raw.n_reject).sum()),
        "n_fr": int(host(raw.n_fr_iters).sum()),
        "n_soc": int(host(raw.n_soc_accept).sum()),
        "qp_trips": int(host(raw.qp_iters_total).sum()),
    }
