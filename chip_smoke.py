"""Smoke run of the PyTorch port (``sqpsolver_tpu_torch``) on one NVIDIA GPU.

Usage, from the repository root, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA::

    python3 chip_smoke.py            # build, check the kernel, run every path
    python3 chip_smoke.py --paths case118   # a partial run: no closing "ok" line
    python3 chip_smoke.py --paths rect118,forms_single   # the other ACOPF formulations
    python3 chip_smoke.py --paths case30,plane_case30,plane_trip118   # the float32 matrix plane
    python3 chip_smoke.py --paths pegase   # case118x12 (n=4128) and the other replicated networks

Phases (any failure raises and the exit code is non-zero):

1. print the card (``nvidia-smi`` name and power limit);
2. build ``sqpsolver_tpu_torch/csrc/chol_tile.cu`` with ``nvcc`` for sm_90a;
3. hold the Cholesky kernel against its plain PyTorch version on the card
   at the case30 path's shapes (32x72x72 K, 32x96x96 capped Schur S), at
   the same per shard of the two-shard sharded path (16x72x72, 16x96x96), at
   256x128x128, at the case118 path's diagonal blocks (16x128x128, and the
   ragged last panels 16x88x88 of K and 16x80x80 of S), at the ragged last
   panel 16x104x104 of the rectangular case118 path's capped S, at the
   structured case118 path's panels of its Schur complement (8x128x128), at
   one case118x12 lane's (1x128x128 and the ragged last panel 1x8x8 of its
   11,016-row stiff Schur complement) and at small
   and odd sizes (3x1x1, 5x7x7, 32x33x33, 32x127x127) that reach every width
   the kernel is compiled for and its ragged edge: max|dL| / max|L| <= 1e-5
   and an exact-zero upper triangle; an indefinite tile must give a
   non-finite factor on that tile only.  At the first twelve shapes the
   kernel, the plain version and one library call
   that computes the same function (``torch.linalg.cholesky_ex``, a yardstick
   that the package's kernel path never calls) are timed with CUDA events, and
   the least time the card could take (``bound_ms``) is computed from the
   shape;
4. hold the 128-panel ``cholesky_blocked`` and ``tri_inv_blocked`` at
   16x344x344 (case118's K), 16x336x336 (its capped S), 16x360x360 (the
   capped S of rectangular case118), 8x896x896 (the stiff Schur
   complement of structured case118 under ``sub_batch=8``) and
   1x11016x11016 (one case118x12 lane's, made on the card)
   against float64 ``torch.linalg.cholesky`` / the float64 inverse of the
   same matrices (max|dL| / max|L| <= 1e-5; max|L Linv - I| <= 1e-4), with
   the kernel's launch count rising by one per 128-panel (3, 3, 3, 7 and 87) per
   factorization and an indefinite matrix
   whose bad pivot lies in the third panel giving a non-finite factor on
   that lane only; time both against one library call each
   (``torch.linalg.cholesky_ex``, ``torch.linalg.solve_triangular(L, I)``)
   and show what TF32 products would do to one n = 344 factor;
5. run the case30 path -- batched ACOPF on MATPOWER case30 with 32 load scenarios,
   dense SQP-TR, mixed_ir factorizations through the kernel, float64 state --
   through ``make_batch_solver`` on ``cuda``; every lane must converge
   (status 0, 1 or 6) to within 1e-6 relative of the per-lane objective the
   JAX package reached on the same data
   (``sqpsolver_tpu_torch/data/anchor_case30_b32.json``), and the kernel's
   launch count over that run must be positive;
6. run the case118 path -- IEEE case118 (n=344, m=609, Schur cap 336) with 16
   load scenarios through ``make_chunked_batch_solver(sub_batch=128,
   rescue_fallback=True)`` on ``cuda``: a float32-factor first pass, then the
   lanes that ended in ``Error_In_Step_Computation`` re-solved with the
   float64 IPM phase 2.  ``x`` must be finite of shape (16, 344); every lane
   the JAX package solved (``anchor_case118_b16.json``) must be solved, to
   within 1e-6 relative of its objective; the float64 phase must take at
   least one trip; the kernel's launch count must be positive (three per
   factorization: both numbers are printed);
7. (no phase: a profile of a path under ``torch.profiler`` is the
   benchmark's, ``python3 sqpbench/run.py --workload <cell> --seed <n>
   --seconds <s> --trace 1``);
8. the single-NLP entry point ``optimize`` on ``cuda`` (float64, direct
   factorizations through the library, as the default parameters have it):
   the verify recipe's three drives (the toy problem with ``OutputFlag=1``,
   whose iteration log is printed, and ``StatisticsFlag=1``, whose arrays
   must have ``iterations + 1`` rows; hs071; ACOPF case9), SQP-LS on the toy
   problem, hs071, hs014 and hs100, and the infeasible and unbounded
   problems under SQP-TR; each must end in the status the JAX package
   reached on the same problem and, where JAX succeeded, within 1e-6
   relative of its objective (``sqpsolver_tpu_torch/data/anchor_hs.json``);
   iterations and wall are printed beside JAX's iterations;
9. the case30 path's configuration under the line search
   (``algorithm="SQP-LS"``) through the package's ``make_solver`` dispatch
   on ``cuda``, 32 load scenarios, the kernel on the float32 IPM phase:
   every lane the JAX package solved (``anchor_ls_case30_b32.json``) must be
   solved within 1e-6 relative of its objective, and the kernel's launch
   count over that run must be positive; wall, SQP-iter/s, solves/s, host
   syncs, launches and the Armijo trial points per batched iteration are
   printed;
10. the structured (BBD) case118 path: the case118 path's data and
    parameters with ``kkt_structured=True`` through
    ``make_chunked_batch_solver(sub_batch=8, rescue_fallback=True)``, as the
    JAX bench drives it with ``SQP_BENCH_STRUCTURED=1``: ``x`` finite of
    shape (16, 344), every lane the JAX package solved
    (``anchor_structured_case118_b16.json``) solved within 1e-6 relative of
    its objective, the kernel's launch count positive (seven per factorization
    of the 896-row stiff Schur complement); wall, SQP-iter/s, solves/s,
    batched trips per IPM phase, host syncs and the lanes that went through
    the fallback are printed;
11. one-lane structured solves through ``optimize`` (float64 direct
    factors): real case118 under the ``ladder`` shift with SOC, also held to
    the published optimum at 1e-4, and the two-stage coupled case9 problem
    (three scenarios sharing the non-slack dispatch, ``power`` shift); each
    must end in the JAX package's status within 1e-6 relative of its
    objective (``anchor_structured_single.json``);
12. the rectangular case118 path: ``acopf_rect`` on case118 (n=344, m=727,
    Schur cap 360 = 128+128+104) with the case118 path's 16 load scenarios
    and parameters through ``make_chunked_batch_solver(sub_batch=128,
    rescue_fallback=True)``, held and reported as phase 6 is
    (``anchor_rect_case118_b16.json``), a lane's objective against the
    nearer of the anchor's two runs of the JAX package (multi-threaded, and
    on one core: ``scripts/torch_anchor.py --one-thread``; that rounding
    alone moves the reference's lane 0 by 4.7e-6);
13. one-lane float64 solves of the other formulations through ``optimize``
    with the reference example's ACOPF parameters: ``acopf_rect`` on case9
    and case118, ``acopf_ivr`` and ``acopf_wr`` on case9 and case30, and
    ``acopf_polar`` on case9 with 12-segment piecewise-linear costs and with
    one HVDC line (both cases written as MATPOWER text to a temporary
    directory and parsed back); each must end in the JAX package's status
    and, where JAX succeeded, within 1e-6 relative of its objective
    (``anchor_forms_single.json``); iterations are printed beside JAX's;
14. the case30 path's data and parameters through the instance-sharded
    solver (``parallel.sharding.make_sharded_solver``), after one
    ``make_batch_solver`` run on the same data: on the one-device mesh
    ``instance_mesh(["cuda:0"])`` the result must be bit-identical lane for
    lane to ``make_batch_solver``'s; on ``["cuda:0", "cuda:0"]`` (two shards
    of 16, solved in turn) every lane must end in the anchor's status within
    1e-6 relative of its objective (``anchor_case30_b32.json``; iterations
    printed, not gated: cuBLAS may pick another algorithm for a batch of 16
    than for 32, so bit equality across batch sizes is no contract); the
    kernel's launch count, set to 0 before each of the two sharded runs and
    read after it, must be positive in each; phase 3 holds the kernel
    against its plain version at the shards' shapes, (16, 72) and (16, 96),
    as well;
15. the same case30 b32 solve on a world-size-1 NCCL process group
    (``parallel.multihost``: ``initialize_distributed`` on
    ``tcp://127.0.0.1:<free port>``, ``global_instance_mesh``,
    ``host_local_batch``, ``make_sharded_solver``): the census
    (``convergence_census``, one NCCL ``all_reduce``) must count as many
    solved lanes as the anchor, every lane within 1e-6 relative of its
    objective, the kernel's launch count positive; the group is destroyed
    at the end, so later phases run as before;
16. one structured instance block-sharded: real IEEE case118
    (``acopf_polar(load_case("case118"), scenario_batchable=False)``, n=344)
    with phase 11's parameters (float64, ``ladder``, SOC,
    ``kkt_structured=True``, ``max_iter=40``, the partition's own 8 parts),
    once through ``make_block_sharded_solver`` over ``["cuda:0",
    "cuda:0"]`` (two groups of four parts) and once unsharded: both must end
    in status 0 within 1e-6 relative of ``anchor_structured_single.json``'s
    case118 objective; iterations printed.  This path factors in float64,
    through the library, so it launches no ``chol_tile``; phases 14 and 15
    carry the kernel;
17. the case30 path's data and configuration under the float32 matrix plane
    (``kkt_precision="mixed_plane"``: K and S assembled, equilibrated and
    factored in float32 through the kernel, the whole 2x2 block refined in
    float64) through ``make_batch_solver``: every lane the JAX package solved
    (``anchor_plane_case30_b32.json``) solved within 1e-6 relative of its
    objective, the kernel's launch count positive; wall (beside phase 5's
    ``mixed_ir`` wall of the same call), iterations, lane-trips, host syncs
    and launches are printed;
18. one KKT trip at case118 b16's shapes under the plane and under
    ``mixed_ir``: the first QP of real case118 b16 at its start point (one
    SQP iteration of phase 6's configuration, n=344, m=609, Schur cap 336),
    its first IPM trip's and its last before a lane leaves the loop,
    ``DenseOp.prepare`` plus one
    ``solve_block`` on the captured arguments, timed between CUDA events and
    as device time under ``torch.profiler``, each result's relative error
    against a float64 LAPACK solve of the same 2x2 system and its residual
    printed (a non-finite solve fails);
19. pegase-scale replicated networks through the structured path
    (``models/power.replicate_case``; ``anchor_replicated.json``, written by
    ``scripts/torch_anchor.py --replicated``): case118x12 (1,416 buses,
    n=4128, m=7319) must partition as in the JAX package (P=81, nd=120,
    ns=708, 136 stiff slots a part, nS=11,016); one structured derivative
    evaluation is timed, with its peak memory and the bus-sum incidence
    products' share of its device time; then one lane through
    ``make_chunked_batch_solver``: (a) the structured bench configuration
    (phase 10's: ``mixed_ir``, ``ladder``, ``pallas``, ``qp_rescue=False``,
    ``max_iter=100``) to the end of its float32 first pass, which factors
    the stiff S through the kernel, ceil(nS / 128) = 87 launches per
    factorization; (b) ``scripts/pegase_solve.py``'s parameters (float64
    ``direct``, ``ladder``, SOC, ``qp_rescue=True``) cut at two SQP
    iterations and held to the JAX package's iterate there (objective
    within 1e-8, max|dx| / max|x| within 1e-6); (c) one-lane float64
    structured solves through ``optimize``: case118x4 with
    ``pegase_solve.py``'s parameters, in the JAX package's status within
    1e-6 of its objective, and ten copies of case30 with
    ``tests/test_structured.py``'s presolve-then-structured flow, as the
    test runs it (JAX's status, solved, within the test's certificate
    [0.98, 1.001] x 10 x case30's optimum: its float32 ``eigh`` shift sends
    the loose presolve elsewhere in another LAPACK) and with the float64
    ``ladder`` shift (JAX's status, within 1e-6 of its objective).  The
    whole case118x12 solves of (a) and (b) (~15 min on the H100) are
    ``scripts/torch_pegase_solve.py 12 --both``.  Wall, SQP iterations,
    batched trips and host seconds per trip of each IPM phase, host syncs,
    launches, whether the lane took the fallback and peak device memory are
    printed.

Standard output ends with these lines, in this order: the kernel's share of
its bound and its ratio to the library call at the paths' eleven shapes; the
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
INVERSE_TOL = 1.0e-4  # max|L Linv - I| of the blocked inverse, float32
#: the stiff Schur complement of one case118x12 lane (phase 19): P=81 parts
#: x 136 stiff slots, 86 panels of 128 and a ragged last one of 8
PEGASE_NS = 11016
BLOCKED = ((16, 344), (16, 336), (16, 360), (8, 896), (1, PEGASE_NS))  # case118 b16's dense K and capped S; rect's capped S; structured S (sub_batch 8); case118x12's S
SLICE_SHAPES = ((32, 72), (32, 96))  # K and the capped Schur S of case30 b32
SHARDED_SHAPES = ((16, 72), (16, 96))  # the same, per shard of the two-shard case30 run
PANEL_SHAPES = ((16, 128), (16, 88), (16, 80), (16, 104))  # case118 b16: K = 128+128+88, S = 128+128+80; rect S = 128+128+104
STRUCTURED_PANEL = (8, 128)  # structured case118, sub_batch 8: S = 7 x 128
PEGASE_PANELS = ((1, 128), (1, PEGASE_NS % 128))  # case118x12's S, one lane: 86 x 128 + 8
TIMED = SLICE_SHAPES + SHARDED_SHAPES + ((256, 128),) + PANEL_SHAPES + (STRUCTURED_PANEL,) + PEGASE_PANELS
SHAPES = TIMED + ((3, 1), (5, 7), (32, 33), (32, 127))
PATHS = ("case30", "case118", "single", "ls_case30", "structured118", "structured_single",
         "rect118", "forms_single", "sharded", "multihost", "block_sharded", "plane_case30",
         "plane_trip118", "pegase")
# phases 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19
#: the chunked case118 paths and their anchors
ANCHOR_118 = {
    "case118": "anchor_case118_b16.json",
    "structured118": "anchor_structured_case118_b16.json",
    "rect118": "anchor_rect_case118_b16.json",
}


def log(*args):
    print(*args, flush=True)


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def spd_batch(torch, rng, batch, n):
    """Seeded SPD float32 tiles, equilibrated to a unit diagonal like the
    KKT matrices the solver factors."""
    import numpy as np

    G = rng.standard_normal((batch, n, n))
    M = G @ G.transpose(0, 2, 1) / n + 0.05 * np.eye(n)
    d = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    M = M * d[:, :, None] * d[:, None, :]
    return torch.tensor(M, dtype=torch.float32, device="cuda")


def spd_card(torch, seed, batch, n):
    """``spd_batch``'s construction made on the card from a seeded CUDA
    generator, for sizes whose product the host would take a minute over."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((batch, n, n), generator=gen, dtype=torch.float64, device="cuda")
    M = torch.matmul(G, G.transpose(-1, -2)) / n
    del G
    M.diagonal(dim1=-2, dim2=-1).add_(0.05)
    d = torch.rsqrt(M.diagonal(dim1=-2, dim2=-1))
    return (M * d[:, :, None] * d[:, None, :]).to(torch.float32)


def cuda_ms(torch, fn, arg, reps=30, inner=1, plug_products=3):
    """Median milliseconds of one ``fn(arg)`` over ``reps`` windows of
    ``inner`` calls each (CUDA events), after 3 warm-up calls.

    With ``inner == 1`` a window is one call as a caller makes it, host
    enqueue time included: right for the plain version, itself a host loop of
    launches.  With ``inner > 1`` the calls of a window are enqueued while the
    card is still busy with ``plug_products`` large matrix products enqueued
    just before the first event, so they run back to back and the window holds device time
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
            for _ in range(plug_products):
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
    the float32 rate (``utils.flops.device_peaks``: the card's data sheet)."""
    from sqpsolver_tpu_torch.utils.flops import device_peaks

    peaks = device_peaks()
    bytes_ms = 2 * batch * n * n * 4 / peaks["hbm"] * 1e3
    ops_ms = batch * n**3 / 3 / peaks["fp32"] * 1e3
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
        "launches": 0,
        "launches_by_path": {},
        "launches_per_factorization": {},
        "max_abs_err": worst,
        **main,
        "bit_identical": identical,
        "timings": timings,
    }


def check_blocked(torch, chol_blocked, card):
    """Phase 4: the 128-panel factorization and inverse at case118's sizes."""
    import numpy as np

    chol_tile = chol_blocked.chol_tile
    cholesky_blocked, tri_inv_blocked = chol_blocked.cholesky_blocked, chol_blocked.tri_inv_blocked
    rng = np.random.default_rng(20240902)
    out = {}
    for batch, n in BLOCKED:
        huge = n > 4096  # case118x12's S: made on the card, timed in fewer windows
        M = spd_card(torch, 20240903, batch, n) if huge else spd_batch(torch, rng, batch, n)
        before = chol_tile.launches
        L = cholesky_blocked(M)
        launched = chol_tile.launches - before
        L64 = torch.linalg.cholesky(M.double())
        rel = ((L - L64).abs().max() / L64.abs().max()).item()
        upper = torch.triu(L, diagonal=1).abs().max().item()
        X = tri_inv_blocked(L)
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        inv_err = (L.double() @ X.double() - eye).abs().max().item()
        x_rel = ((X - torch.linalg.inv(L64)).abs().max() / X.abs().max()).item()
        log(f"blocked ({batch},{n},{n}): cholesky_blocked max|dL|/max|L| {rel:.3e} (tol "
            f"{KERNEL_TOL:g}) against float64, max|upper| {upper}, {launched} chol_tile "
            f"launches (one per 128-panel); tri_inv_blocked max|L Linv - I| {inv_err:.3e} (tol {INVERSE_TOL:g}), "
            f"max|dX|/max|X| {x_rel:.3e}")
        if not (rel <= KERNEL_TOL and upper == 0.0 and inv_err <= INVERSE_TOL):
            raise AssertionError(f"blocked routines off at ({batch},{n},{n})")
        panels = -(-n // 128)
        if launched != panels:
            raise AssertionError(f"cholesky_blocked launched {launched} tiles at n={n}, not {panels}")
        bad = M[:4].clone()
        lane = min(2, batch - 1)
        bad[lane, 300, 300] = -1.0e3  # a bad pivot in the third panel
        finite = torch.isfinite(cholesky_blocked(bad)).flatten(1).all(-1).tolist()
        if finite != [i != lane for i in range(min(4, batch))]:
            raise AssertionError(f"indefinite third panel at n={n}: finite lanes {finite}")
        del bad
        eye32 = torch.eye(n, device="cuda").expand(batch, n, n).contiguous()

        def solve_triangular(A):
            return torch.linalg.solve_triangular(A, eye32, upper=False)

        # device times: each routine is ~70 launches at three panels and
        # ~160 at seven, and the calls of a window must stay queued behind
        # the plug.  Ten calls at 896 drained the queue even behind sixty
        # products (the host then waits to enqueue, likely on the card's
        # bounded queue of pending launches), so seven panels take four calls
        big = n > 384
        timed = dict(reps=5 if huge else 15, inner=2 if huge else 4 if big else 10,
                     plug_products=60 if big else 12)
        times = {
            "cholesky_blocked_ms": cuda_ms(torch, cholesky_blocked, M, **timed),
            "cholesky_ex_ms": cuda_ms(torch, torch.linalg.cholesky_ex, M, **timed),
            "tri_inv_blocked_ms": cuda_ms(torch, tri_inv_blocked, L, **timed),
            "solve_triangular_ms": cuda_ms(torch, solve_triangular, L, **timed),
            "cholesky_blocked_alone_ms": cuda_ms(torch, cholesky_blocked, M, reps=5 if huge else 15),
            "tri_inv_blocked_alone_ms": cuda_ms(torch, tri_inv_blocked, L, reps=5 if huge else 15),
        }
        out[f"{batch}x{n}x{n}"] = dict(times, rel_err=rel, inverse_err=inv_err, launches=launched)
        log(f"blocked ({batch},{n},{n}) on {card}: indefinite third panel non-finite on its "
            f"lane only; device time: cholesky_blocked {times['cholesky_blocked_ms']:.4f} ms "
            f"against cholesky_ex {times['cholesky_ex_ms']:.4f} ms; tri_inv_blocked "
            f"{times['tri_inv_blocked_ms']:.4f} ms against solve_triangular(L, I) "
            f"{times['solve_triangular_ms']:.4f} ms; one call alone, host enqueue time "
            f"included: cholesky_blocked {times['cholesky_blocked_alone_ms']:.4f} ms, "
            f"tri_inv_blocked {times['tri_inv_blocked_alone_ms']:.4f} ms")
    # what TF32 products would cost one n = 344 factor (not a gate: the
    # solver and this script keep float32 products true float32)
    M = spd_batch(torch, rng, *BLOCKED[0])
    L64 = torch.linalg.cholesky(M.double())
    errs = {}
    for name, tf32 in (("off", False), ("on", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        errs[name] = ((cholesky_blocked(M) - L64).abs().max() / L64.abs().max()).item()
    torch.backends.cuda.matmul.allow_tf32 = False
    out["tf32"] = errs
    log(f"blocked (16,344,344): max|dL|/max|L| with TF32 products off {errs['off']:.3e}, "
        f"on {errs['on']:.3e}")
    return out


def run_slice(torch, record):
    """Phase 4: the case30 b32 slice through the port's public entry points."""
    import numpy as np

    from sqpsolver_tpu_torch import batch_data, make_batch_solver
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    anchor, nlp, theta, params = _case30_fleet()
    batch = anchor["batch"]
    log(f"slice: {anchor['case']} n={nlp.n} m={nlp.m} batch={batch} params={anchor['params']}")
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
    record["launches"] += launches
    record["launches_by_path"]["case30_b32"] = launches

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
    return wall


def _anchor(name):
    with open(os.path.join(ROOT, "sqpsolver_tpu_torch", "data", name)) as fh:
        return json.load(fh)


def run_single(torch, record):
    """Phase 8: one NLP at a time through ``optimize`` on the card, held to
    the JAX package's result on the same problem."""
    import numpy as np

    import sqpsolver_tpu_torch as tp
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.models import hs
    from sqpsolver_tpu_torch.models.acopf import acopf_polar
    from sqpsolver_tpu_torch.models.power import case9
    from sqpsolver_tpu_torch.models.toy import toy_nlp
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    anchor = _anchor("anchor_hs.json")
    drives = anchor["params"]["drives"]
    ls, trust = anchor["params"]["SQP-LS"], anchor["params"]["SQP-TR"]
    runs = [
        ("drive toy", toy_nlp(), dict(drives["toy"], OutputFlag=1, StatisticsFlag=1),
         anchor["drives"]["toy"]),
        ("drive hs071", hs.hs_problem("hs071").nlp, drives["hs071"], anchor["drives"]["hs071"]),
        ("drive case9", acopf_polar(case9(), scenario_batchable=False), drives["case9"],
         anchor["drives"]["case9"]),
        ("SQP-LS toy", toy_nlp(), ls, anchor["SQP-LS"]["toy"]),
    ]
    runs += [(f"SQP-LS {name}", hs.hs_problem(name).nlp, ls, anchor["SQP-LS"][name])
             for name in ("hs071", "hs014", "hs100")]
    runs += [(f"SQP-TR {name}", getattr(hs, f"{name}_nlp")(), trust, anchor["SQP-TR"][name])
             for name in ("infeasible", "unbounded")]
    chol_tile.launches = 0
    syncs0 = any_lane.syncs
    t_phase = time.perf_counter()
    failures = []
    for label, nlp, kw, want in runs:
        t0 = time.perf_counter()
        res = tp.optimize(nlp, tp.Parameters(**kw))  # the card by default
        wall = time.perf_counter() - t0
        ok = int(res.status) == want["status"]
        rel = abs(res.obj_val - want["obj"]) / max(1.0, abs(want["obj"]))
        if tp.is_success(want["status"]):
            ok = ok and rel <= OBJ_RTOL
        if kw.get("StatisticsFlag"):
            rows = {k: v.shape for k, v in res.statistics.items()}
            log(f"single: {label}: statistics {sorted(rows)} of {set(rows.values())} rows")
            ok = ok and set(rows.values()) == {(res.iterations + 1,)}
        log(f"single: {label}: {res.status_name} obj {res.obj_val:.10g} in {res.iterations} "
            f"iterations ({res.qp_iters_total} QP trips), wall {wall:.3f} s; JAX "
            f"{tp.status_name(want['status'])} obj {want['obj']:.10g} in {want['iterations']} "
            f"iterations ({want['qp_iters_total']} QP trips); rel. obj diff {rel:.2e}"
            + ("" if ok else "  <-- MISMATCH"))
        if not np.all(np.isfinite(res.x)) or res.x.shape != (nlp.n,):
            ok = False
        if not ok:
            failures.append(label)
    launches = chol_tile.launches
    record["launches"] += launches
    record["launches_by_path"]["single_nlp"] = launches
    log(f"single: {len(runs)} solves in {time.perf_counter() - t_phase:.3f} s, "
        f"{any_lane.syncs - syncs0} host syncs, {launches} chol_tile launches (float64 "
        f"direct factors go to the library)")
    if failures:
        raise AssertionError(f"single: off the JAX anchor: {failures}")


def run_ls_case30(torch, record):
    """Phase 9: the case30 configuration under SQP-LS through the package's
    ``make_solver`` dispatch."""
    import numpy as np

    import sqpsolver_tpu_torch as tp
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.algorithms.sqp_ls import backtracking_alphas
    from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu_torch.models.matpower import load_case
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    anchor = _anchor("anchor_ls_case30_b32.json")
    case = load_case(anchor["case"])
    nlp = acopf_polar(case)
    batch = anchor["batch"]
    theta = load_scenarios(case, batch, seed=anchor["seed"], spread=anchor["spread"])
    params = tp.Parameters(**anchor["params"])
    solver = tp.make_solver(nlp, params)
    log(f"ls_case30: {case.name} n={nlp.n} m={nlp.m} batch={batch} params={anchor['params']}")
    data = tp.batch_data(nlp, batch, theta=theta)  # on the card by default
    torch.cuda.synchronize()
    chol_tile.launches = 0
    syncs0 = any_lane.syncs
    t0 = time.perf_counter()
    out = solver(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chol_tile.launches
    syncs = any_lane.syncs - syncs0
    record["launches"] += launches
    record["launches_by_path"]["ls_case30_b32"] = launches

    status = out.status.cpu().numpy()
    obj = out.obj_val.cpu().numpy()
    ref_status = np.asarray(anchor["lanes"]["status"])
    ref = np.asarray(anchor["lanes"]["obj"])
    ref_ok = np.isin(ref_status, [0, 1, 6])
    ok = np.isin(status, [0, 1, 6])
    rel = np.abs(obj - ref) / np.abs(ref)
    iters = int(out.iterations.sum().item())
    batched_iters = int(out.iterations.max().item()) - 1
    trials = len(backtracking_alphas(params.tau, params.min_alpha, torch.float64)) * batch
    n_ok = int(ok.sum())
    log(f"ls_case30: wall {wall:.4f} s, {iters} SQP iterations ({iters / wall:.2f} SQP-iter/s), "
        f"{n_ok}/{batch} solved ({n_ok / wall:.3f} solves/s), "
        f"{int(out.qp_iters_total.sum().item())} IPM trips, {syncs} host syncs, {launches} "
        f"chol_tile launches; {batched_iters} batched iterations, each evaluating {trials} "
        f"Armijo trial points in one call; {int(out.n_soc_accept.sum().item())} SOC steps")
    log(f"ls_case30: JAX anchor {int(ref_ok.sum())}/{batch} solved, "
        f"{anchor['totals']['iterations']} iterations, {anchor['totals']['qp_trips']} IPM trips "
        f"({anchor['reference']['platform']}, kkt_backend={anchor['reference']['kkt_backend']}); "
        f"per-lane iterations equal to the anchor's on {int((out.iterations.cpu().numpy() == np.asarray(anchor['lanes']['iterations'])).sum())}/{batch} lanes")
    log(f"ls_case30: objective rel. diff to the anchor over the lanes it solved: max "
        f"{rel[ref_ok].max():.3e} (tol {OBJ_RTOL:g}); statuses {sorted(set(status.tolist()))}")
    if out.x.shape != (batch, nlp.n) or not torch.isfinite(out.x).all().item():
        raise AssertionError("ls_case30: x is not finite of shape (batch, n)")
    if not ok[ref_ok].all():
        raise AssertionError(
            f"ls_case30: lanes the anchor solved and the port did not: {np.nonzero(ref_ok & ~ok)[0]}"
        )
    if not (rel[ref_ok] <= OBJ_RTOL).all():
        raise AssertionError(f"ls_case30: lanes off the anchor: {np.nonzero(ref_ok & (rel > OBJ_RTOL))[0]}")
    if launches <= 0:
        raise AssertionError("ls_case30: the Cholesky kernel was never launched")


def case118_solver(torch, tag="case118"):
    """A chunked case118 path's configuration (``ANCHOR_118[tag]``: its
    formulation, data, parameters and chunking) from its anchor file,
    through the port's public entry points."""
    from sqpsolver_tpu_torch import Parameters, batch_data, make_chunked_batch_solver
    from sqpsolver_tpu_torch.models import acopf
    from sqpsolver_tpu_torch.models.matpower import load_case

    anchor = _anchor(ANCHOR_118[tag])
    case = load_case(anchor["case"])
    nlp = getattr(acopf, f"acopf_{anchor.get('form', 'polar')}")(case)
    batch = anchor["batch"]
    theta = acopf.load_scenarios(case, batch, seed=anchor["seed"], spread=anchor["spread"])
    kw = anchor["params"]
    log(f"{tag}: {case.name} n={nlp.n} m={nlp.m} batch={batch} chunked={anchor['chunked']} "
        f"params={kw}")
    solver = make_chunked_batch_solver(nlp, Parameters(**kw), **anchor["chunked"])

    def solve():
        data = batch_data(nlp, batch, theta=theta)  # on the card by default
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver(data)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    return anchor, nlp, solver, solve


def run_case118(torch, record, tag="case118"):
    """Phase 6 (``case118``, dense), 10 (``structured118``) or 12
    (``rect118``, dense, rectangular): a case118 path through the chunked
    solver with its rescue fallback."""
    import numpy as np

    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile, cholesky_blocked
    from sqpsolver_tpu_torch.ops.qp_ipm import solve_qp

    structured = tag == "structured118"
    anchor, nlp, solver, solve = case118_solver(torch, tag)
    batch = anchor["batch"]
    chol_tile.launches = 0
    calls0 = cholesky_blocked.calls
    syncs0 = any_lane.syncs
    trips0 = dict(solve_qp.loop_trips)
    secs0 = dict(solve_qp.phase_seconds)
    out, wall = solve()
    launches = chol_tile.launches
    calls = cholesky_blocked.calls - calls0
    stats = dict(solver.stats)
    rounds = stats["rounds"] + stats["fallback_rounds"]
    syncs = any_lane.syncs - syncs0 + rounds
    trips = {k: solve_qp.loop_trips[k] - trips0[k] for k in trips0}
    secs = {k: solve_qp.phase_seconds[k] - secs0[k] for k in secs0}
    record["launches"] += launches
    record["launches_by_path"][f"{tag}_b16"] = launches
    record["launches_per_factorization"][tag] = launches / max(calls, 1)

    status = out.status.cpu().numpy()
    obj = out.obj_val.cpu().numpy()
    ref_status = np.asarray(anchor["lanes"]["status"])
    ref = np.asarray(anchor["lanes"]["obj"])
    ref_ok = np.isin(ref_status, [0, 1, 6])
    ok = np.isin(status, [0, 1, 6])
    rel = rel_anchor = np.abs(obj - ref) / np.abs(ref)
    if "one_thread" in anchor:
        # the reference run again on one core: where rounding decides a
        # lane's stopping point, the JAX package has two answers
        ref1 = np.asarray(anchor["one_thread"]["obj"])
        rel = np.minimum(rel_anchor, np.abs(obj - ref1) / np.abs(ref1))
    iters = int(out.iterations.sum().item())
    lane_trips = int(out.qp_iters_total.sum().item())
    n_ok = int(ok.sum())
    what = ("S spans seven 128-panels; the interiors and the separator go to the library"
            if structured else f"K ({nlp.n}) and S both span three 128-panels")
    log(f"{tag}: wall {wall:.4f} s, {iters} SQP iterations ({iters / wall:.2f} SQP-iter/s), "
        f"{n_ok}/{batch} solved ({n_ok / wall:.4f} solves/s), {lane_trips} lane-IPM-trips "
        f"(a rescued QP counts its float64 trips only), {rounds} rounds "
        f"({stats['rounds']} first pass, {stats['fallback_rounds']} fallback), {syncs} host "
        f"syncs, {len(stats['fallback_lanes'])} lanes through the fallback "
        f"{stats['fallback_lanes']}")
    log(f"{tag}: batched IPM trips phase 1 (float32 factors) {trips[1]} in {secs[1]:.3f} s, "
        f"phase 2 (float64 factors) {trips[2]} in {secs[2]:.3f} s; {launches} chol_tile "
        f"launches over {calls} kernel-route factorizations ({launches / max(calls, 1):.3f} "
        f"per factorization; {what})")
    log(f"{tag}: JAX anchor {int(ref_ok.sum())}/{batch} solved, "
        f"{anchor['totals']['iterations']} iterations (port {iters}), fallback lanes "
        f"{anchor['fallback_lanes']} ({anchor['reference']['platform']}, kkt_backend="
        f"{anchor['reference']['kkt_backend']}); statuses port {status.tolist()} "
        f"anchor {ref_status.tolist()}")
    log(f"{tag}: objective rel. diff to the anchor over the {int(ref_ok.sum())} lanes it "
        f"solved: max {np.max(rel_anchor[ref_ok], initial=0.0):.3e}; over the "
        f"lanes both solved: max {np.max(rel_anchor[ref_ok & ok], initial=0.0):.3e}; per lane "
        f"{np.array2string(rel_anchor, precision=2)}, port iterations "
        f"{out.iterations.cpu().numpy().tolist()}, anchor {anchor['lanes']['iterations']}")
    if "one_thread" in anchor:
        log(f"{tag}: the reference on one core (anchor's one_thread): iterations "
            f"{anchor['one_thread']['iterations']}; objective rel. diff to the nearer of "
            f"the two reference runs: max {np.max(rel[ref_ok], initial=0.0):.3e}; per lane "
            f"{np.array2string(rel, precision=2)}")
    log(f"{tag}: gate: every lane the anchor solved solved, within {OBJ_RTOL:g} of a "
        f"reference run: max {np.max(rel[ref_ok], initial=0.0):.3e}")
    if out.x.shape != (batch, nlp.n) or not torch.isfinite(out.x).all().item():
        raise AssertionError(f"{tag}: x is not finite of shape (batch, n)")
    if not ok[ref_ok].all():
        raise AssertionError(
            f"{tag}: lanes the anchor solved and the port did not: {np.nonzero(ref_ok & ~ok)[0]}"
        )
    if not (rel[ref_ok] <= OBJ_RTOL).all():
        raise AssertionError(f"{tag}: lanes off the anchor: {np.nonzero(ref_ok & (rel > OBJ_RTOL))[0]}")
    if launches <= 0:
        raise AssertionError(f"{tag}: the Cholesky kernel was never launched")
    if not structured and trips[2] <= 0:
        raise AssertionError(f"{tag}: the float64 IPM phase 2 took no trip")


def run_structured_single(torch, record):
    """Phase 11: one-lane structured solves through ``optimize`` on the card
    (float64 direct factors: the library's), held to the JAX package's
    result on the same problem."""
    import numpy as np

    import sqpsolver_tpu_torch as tp
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu_torch.models.matpower import VENDORED_OPTIMA, load_case
    from sqpsolver_tpu_torch.models.power import case9
    from sqpsolver_tpu_torch.models.stochastic import couple_scenarios, pg_shared_mask
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    anchor = _anchor("anchor_structured_single.json")
    cp = anchor["coupled"]
    base9 = case9()
    base = acopf_polar(base9)
    coupled = couple_scenarios(
        base, load_scenarios(base9, cp["K"], seed=cp["seed"], spread=cp["spread"]),
        pg_shared_mask(base9, base),
    )
    runs = [
        ("case118", acopf_polar(load_case("case118"), scenario_batchable=False)),
        ("coupled_case9", coupled),
    ]
    chol_tile.launches = 0
    syncs0 = any_lane.syncs
    t_phase = time.perf_counter()
    failures = []
    for name, nlp in runs:
        want = anchor["solves"][name]
        params = tp.Parameters(**anchor["params"][name])
        t0 = time.perf_counter()
        res = tp.optimize(nlp, params)  # the card by default
        wall = time.perf_counter() - t0
        rel = abs(res.obj_val - want["obj"]) / max(1.0, abs(want["obj"]))
        ok = int(res.status) == want["status"] and rel <= OBJ_RTOL
        ok = ok and res.x.shape == (nlp.n,) and bool(np.all(np.isfinite(res.x)))
        extra = ""
        if name == "case118":
            pub = abs(res.obj_val - VENDORED_OPTIMA["case118"]) / VENDORED_OPTIMA["case118"]
            ok = ok and pub <= 1e-4
            extra = f"; rel. diff to the published optimum {pub:.2e} (tol 1e-4)"
        log(f"structured_single: {name} (n={nlp.n}, m={nlp.m}): {res.status_name} obj "
            f"{res.obj_val:.10g} in {res.iterations} iterations ({res.qp_iters_total} QP trips), "
            f"wall {wall:.3f} s; JAX {tp.status_name(want['status'])} obj {want['obj']:.10g} in "
            f"{want['iterations']} iterations ({want['qp_iters_total']} QP trips); rel. obj diff "
            f"{rel:.2e}{extra}" + ("" if ok else "  <-- MISMATCH"))
        if not ok:
            failures.append(name)
    launches = chol_tile.launches
    record["launches"] += launches
    record["launches_by_path"]["structured_single"] = launches
    log(f"structured_single: {len(runs)} solves in {time.perf_counter() - t_phase:.3f} s, "
        f"{any_lane.syncs - syncs0} host syncs, {launches} chol_tile launches (float64 "
        f"direct factors go to the library)")
    if failures:
        raise AssertionError(f"structured_single: off the JAX anchor: {failures}")


def run_forms_single(torch, record):
    """Phase 13: one-lane solves of the other ACOPF formulations and of the
    polar extensions through ``optimize`` on the card (float64 direct
    factors: the library's), held to the JAX package's result on the same
    problem."""
    import tempfile

    import numpy as np

    import sqpsolver_tpu_torch as tp
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.models import acopf, matpower
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    anchor = _anchor("anchor_forms_single.json")
    params = tp.Parameters(**anchor["params"])
    chol_tile.launches = 0
    syncs0 = any_lane.syncs
    t_phase = time.perf_counter()
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (form, case_name, segs, dc) in anchor["forms"].items():
            if segs or dc:  # a PWL or dcline variant of case9, as MATPOWER text
                case = matpower.case9_variant(tmp, segs, dc)
            else:
                case = matpower.load_case(case_name)
            nlp = getattr(acopf, f"acopf_{form}")(case, scenario_batchable=False)
            want = anchor["solves"][name]
            t0 = time.perf_counter()
            res = tp.optimize(nlp, params)  # the card by default
            wall = time.perf_counter() - t0
            rel = abs(res.obj_val - want["obj"]) / max(1.0, abs(want["obj"]))
            ok = int(res.status) == want["status"]
            if tp.is_success(want["status"]):
                ok = ok and rel <= OBJ_RTOL
            ok = ok and res.x.shape == (nlp.n,) and bool(np.all(np.isfinite(res.x)))
            log(f"forms_single: {name} ({nlp.name}, n={nlp.n}, m={nlp.m}, num_linear="
                f"{nlp.num_linear}): {res.status_name} obj {res.obj_val:.10g} in "
                f"{res.iterations} iterations ({res.qp_iters_total} QP trips), wall {wall:.3f} s; "
                f"JAX {tp.status_name(want['status'])} obj {want['obj']:.10g} in "
                f"{want['iterations']} iterations ({want['qp_iters_total']} QP trips); rel. obj "
                f"diff {rel:.2e}" + ("" if ok else "  <-- MISMATCH"))
            if not ok:
                failures.append(name)
    launches = chol_tile.launches
    record["launches"] += launches
    record["launches_by_path"]["forms_single"] = launches
    log(f"forms_single: {len(anchor['forms'])} solves in {time.perf_counter() - t_phase:.3f} s, "
        f"{any_lane.syncs - syncs0} host syncs, {launches} chol_tile launches (float64 "
        f"direct factors go to the library)")
    if failures:
        raise AssertionError(f"forms_single: off the JAX anchor: {failures}")


def _case30_fleet(name="anchor_case30_b32.json"):
    """A case30 b32 path's anchor, NLP, scenarios and parameters."""
    from sqpsolver_tpu_torch import Parameters
    from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu_torch.models.matpower import load_case

    anchor = _anchor(name)
    case = load_case(anchor["case"])
    theta = load_scenarios(case, anchor["batch"], seed=anchor["seed"], spread=anchor["spread"])
    return anchor, acopf_polar(case), theta, Parameters(**anchor["params"])


def _fleet_gate(tag, anchor, out, nlp):
    """Every lane finite, in the anchor's status, within ``OBJ_RTOL`` of its
    objective; returns the largest relative difference."""
    import numpy as np

    batch = anchor["batch"]
    status = out.status.cpu().numpy()
    rel = np.abs(out.obj_val.cpu().numpy() / np.asarray(anchor["lanes"]["obj"]) - 1.0)
    if out.x.shape != (batch, nlp.n) or not bool(out.x.isfinite().all().item()):
        raise AssertionError(f"{tag}: x is not finite of shape (batch, n)")
    if status.tolist() != anchor["lanes"]["status"]:
        raise AssertionError(f"{tag}: statuses {status.tolist()} differ from the anchor's")
    if not (rel <= OBJ_RTOL).all():
        raise AssertionError(f"{tag}: lanes off the anchor: {np.nonzero(rel > OBJ_RTOL)[0]}")
    return float(rel.max())


def run_sharded(torch, record, card):
    """Phase 14: case30 b32 through the instance-sharded solver."""
    import numpy as np

    from sqpsolver_tpu_torch import batch_data, make_batch_solver
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile
    from sqpsolver_tpu_torch.parallel.sharding import instance_mesh, make_sharded_solver

    anchor, nlp, theta, params = _case30_fleet()
    data = batch_data(nlp, anchor["batch"], theta=theta)  # on the card by default

    def timed(solver):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver(data)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the comparison run, before the counts are set to 0
    whole, wall_whole = timed(make_batch_solver(nlp, params))
    meshes = {"one": instance_mesh(["cuda:0"]), "two": instance_mesh(["cuda:0", "cuda:0"])}
    solvers = {k: make_sharded_solver(nlp, params, m) for k, m in meshes.items()}
    launches = {}
    chol_tile.launches = 0
    out1, wall1 = timed(solvers["one"])
    launches["one"] = chol_tile.launches
    chol_tile.launches = 0
    out2, wall2 = timed(solvers["two"])
    launches["two"] = chol_tile.launches
    for k, n in launches.items():
        record["launches"] += n
        record["launches_by_path"][f"sharded_{k}_case30_b32"] = n
    fields = ("x", "obj_val", "status", "iterations", "qp_iters_total", "mult_g", "prim_infeas")
    same = {f: torch.equal(getattr(out1, f), getattr(whole, f)) for f in fields}
    rel2 = _fleet_gate("sharded (two shards)", anchor, out2, nlp)
    it_whole = whole.iterations.cpu().numpy()
    it2 = out2.iterations.cpu().numpy()
    log(f"sharded on {card}: make_batch_solver {wall_whole:.4f} s; one-device mesh "
        f"{wall1:.4f} s, bit-identical to it lane for lane: {all(same.values())} {same}")
    log(f"sharded on {card}: two shards of 16 on cuda:0 in turn {wall2:.4f} s, "
        f"{int(it2.sum())} iterations (whole batch {int(it_whole.sum())}, anchor "
        f"{anchor['totals']['iterations']}; lanes whose count moved "
        f"{np.nonzero(it2 != it_whole)[0].tolist()}), max rel. obj diff to the anchor "
        f"{rel2:.3e} (tol {OBJ_RTOL:g}); chol_tile launches: one-device mesh "
        f"{launches['one']}, two shards {launches['two']}")
    if not all(same.values()):
        raise AssertionError(f"sharded: the one-device mesh differs from make_batch_solver: {same}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"sharded ({k}): the Cholesky kernel was never launched")


def run_multihost(torch, record, card):
    """Phase 15: case30 b32 on a world-size-1 NCCL process group."""
    import socket

    import torch.distributed as dist

    from sqpsolver_tpu_torch import batch_data
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile
    from sqpsolver_tpu_torch.parallel import multihost as mh
    from sqpsolver_tpu_torch.parallel.sharding import make_sharded_solver

    anchor, nlp, theta, params = _case30_fleet()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mh.initialize_distributed(init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        backend = dist.get_backend()
        mesh = mh.global_instance_mesh()
        log(f"multihost: process group up in {time.perf_counter() - t0:.3f} s, backend "
            f"{backend}, rank {mesh.rank} of {mesh.world}, devices {mesh.devices}")
        if backend != "nccl":
            raise AssertionError(f"multihost: backend {backend}, not nccl")
        gdata = mh.host_local_batch(batch_data(nlp, anchor["batch"], theta=theta,
                                               device=mesh.devices[0]), mesh)
        solver = make_sharded_solver(nlp, params, mesh)
        torch.cuda.synchronize()
        chol_tile.launches = 0
        t0 = time.perf_counter()
        out = solver(gdata)
        census = mh.convergence_census(out.status, mesh)
        wall = time.perf_counter() - t0
        launches = chol_tile.launches
    finally:
        dist.destroy_process_group()
    record["launches"] += launches
    record["launches_by_path"]["multihost_case30_b32"] = launches
    want = sum(s in (0, 1, 6) for s in anchor["lanes"]["status"])
    rel = _fleet_gate("multihost", anchor, out, nlp)
    log(f"multihost on {card}: wall {wall:.4f} s (census included), census {census} "
        f"through NCCL all_reduce, anchor solved {want}; max rel. obj diff to the anchor "
        f"{rel:.3e}; {int(out.iterations.sum().item())} iterations; {launches} chol_tile "
        f"launches; group destroyed")
    if census["n_done_ok"] != want or census["n_total"] != anchor["batch"]:
        raise AssertionError(f"multihost: census {census}, anchor solved {want}")
    if launches <= 0:
        raise AssertionError("multihost: the Cholesky kernel was never launched")


def run_block_sharded(torch, record, card):
    """Phase 16: one structured case118 instance block-sharded over a
    repeated-device mesh, and unsharded."""
    import numpy as np

    import sqpsolver_tpu_torch as tp
    from sqpsolver_tpu_torch.models.acopf import acopf_polar
    from sqpsolver_tpu_torch.models.matpower import load_case
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile
    from sqpsolver_tpu_torch.ops.kkt_bbd import part_groups
    from sqpsolver_tpu_torch.parallel.sharding import instance_mesh, make_block_sharded_solver
    from sqpsolver_tpu_torch.structure import build_block_structure

    anchor = _anchor("anchor_structured_single.json")
    want = anchor["solves"]["case118"]
    params = tp.Parameters(**anchor["params"]["case118"])
    nlp = acopf_polar(load_case("case118"), scenario_batchable=False)
    g_l = np.broadcast_to(np.asarray(nlp.g_l, dtype=np.float64), (nlp.m,))
    g_u = np.broadcast_to(np.asarray(nlp.g_u, dtype=np.float64), (nlp.m,))
    bs = build_block_structure(nlp.n, nlp.m, nlp.structure, np.isfinite(g_l) & (g_l == g_u),
                               n_parts=(params.kkt_parts or None))
    mesh = instance_mesh(["cuda:0", "cuda:0"], axis="block")
    groups = part_groups(bs.P, mesh.devices)
    log(f"block_sharded: case118 n={nlp.n} m={nlp.m}, kkt_parts={params.kkt_parts} (the "
        f"partition's own), P={bs.P} parts of nd={bs.nd}, separator ns={bs.ns}; groups "
        f"{[(str(d), sl.start, sl.stop) for d, sl in groups]}")
    if bs.P % len(mesh.devices):
        raise AssertionError(f"block_sharded: P={bs.P} does not divide over the mesh")
    solvers = {
        "block-sharded": make_block_sharded_solver(nlp, params, mesh),
        "unsharded": tp.make_solver(nlp, params),
    }
    data = tp.batch_data(nlp, 1)  # on the card by default
    failures = []
    chol_tile.launches = 0
    for name, solver in solvers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tp.from_raw(solver(data), 0.0)
        wall = time.perf_counter() - t0
        rel = abs(res.obj_val - want["obj"]) / abs(want["obj"])
        ok = int(res.status) == 0 == want["status"] and rel <= OBJ_RTOL
        ok = ok and res.x.shape == (nlp.n,) and bool(np.all(np.isfinite(res.x)))
        log(f"block_sharded on {card}: {name}: {res.status_name} obj {res.obj_val:.10g} in "
            f"{res.iterations} iterations ({res.qp_iters_total} QP trips), wall {wall:.3f} s; "
            f"JAX obj {want['obj']:.10g} in {want['iterations']} iterations; rel. obj diff "
            f"{rel:.2e} (tol {OBJ_RTOL:g})" + ("" if ok else "  <-- MISMATCH"))
        if not ok:
            failures.append(name)
    launches = chol_tile.launches
    record["launches_by_path"]["block_sharded_case118"] = launches
    log(f"block_sharded: {launches} chol_tile launches (float64 factors go to the library)")
    if failures:
        raise AssertionError(f"block_sharded: off the JAX anchor: {failures}")


def run_plane_case30(torch, record, card, wall_ir=None):
    """Phase 17: case30 b32 under the float32 matrix plane
    (``kkt_precision="mixed_plane"``), phase 5's configuration otherwise."""
    import numpy as np

    from sqpsolver_tpu_torch import batch_data, make_batch_solver
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile

    anchor, nlp, theta, params = _case30_fleet("anchor_plane_case30_b32.json")
    batch = anchor["batch"]
    log(f"plane_case30: {anchor['case']} n={nlp.n} m={nlp.m} batch={batch} params={anchor['params']}")
    solver = make_batch_solver(nlp, params)

    def solve():
        data = batch_data(nlp, batch, theta=theta)  # on the card by default
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver(data)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, first = solve()
    chol_tile.launches = 0
    syncs0 = any_lane.syncs
    out, wall = solve()
    launches = chol_tile.launches
    syncs = any_lane.syncs - syncs0
    record["launches"] += launches
    record["launches_by_path"]["plane_case30_b32"] = launches

    status = out.status.cpu().numpy()
    obj = out.obj_val.cpu().numpy()
    ref_status = np.asarray(anchor["lanes"]["status"])
    ref = np.asarray(anchor["lanes"]["obj"])
    ref_ok = np.isin(ref_status, [0, 1, 6])
    ok = np.isin(status, [0, 1, 6])
    rel = np.abs(obj - ref) / np.abs(ref)
    iters = int(out.iterations.sum().item())
    trips = int(out.qp_iters_total.sum().item())
    n_ok = int(ok.sum())
    beside = (f"; phase 5 (mixed_ir) in this call {wall_ir:.4f} s, plane / mixed_ir "
              f"{wall / wall_ir:.3f}" if wall_ir else "; phase 5 not run in this call")
    log(f"plane_case30 on {card}: wall {wall:.4f} s (first run {first:.4f} s){beside}")
    log(f"plane_case30: {iters} SQP iterations ({iters / wall:.2f} SQP-iter/s), {n_ok}/{batch} "
        f"solved ({n_ok / wall:.3f} solves/s), {trips} lane-IPM-trips, {syncs} host syncs, "
        f"{launches} chol_tile launches")
    log(f"plane_case30: JAX anchor {int(ref_ok.sum())}/{batch} solved, "
        f"{anchor['totals']['iterations']} iterations, {anchor['totals']['qp_trips']} IPM trips "
        f"({anchor['reference']['platform']}, kkt_backend={anchor['reference']['kkt_backend']}); "
        f"statuses port {status.tolist()} anchor {ref_status.tolist()}; port iterations "
        f"{out.iterations.cpu().numpy().tolist()}, anchor {anchor['lanes']['iterations']}")
    log(f"plane_case30: objective rel. diff to the anchor over the lanes it solved: max "
        f"{np.max(rel[ref_ok], initial=0.0):.3e} (tol {OBJ_RTOL:g})")
    if out.x.shape != (batch, nlp.n) or not torch.isfinite(out.x).all().item():
        raise AssertionError("plane_case30: x is not finite of shape (batch, n)")
    if not ok[ref_ok].all():
        raise AssertionError(
            f"plane_case30: lanes the anchor solved and the port did not: {np.nonzero(ref_ok & ~ok)[0]}"
        )
    if not (rel[ref_ok] <= OBJ_RTOL).all():
        raise AssertionError(f"plane_case30: lanes off the anchor: {np.nonzero(ref_ok & (rel > OBJ_RTOL))[0]}")
    if launches <= 0:
        raise AssertionError("plane_case30: the Cholesky kernel was never launched")
    return wall


def capture_case118_kkt(torch):
    """The KKT systems the IPM factors in the first QP of real case118 b16 at
    its start point: one SQP iteration of dense case118's configuration, with
    the ``DenseOp.prepare`` arguments of every trip of that QP and of the
    first ``solve_block`` after each kept, up to the last trip on which
    every lane is still iterating."""
    from sqpsolver_tpu_torch import Parameters, batch_data, make_batch_solver
    from sqpsolver_tpu_torch.models import acopf
    from sqpsolver_tpu_torch.models.matpower import load_case
    from sqpsolver_tpu_torch.ops import qp_ipm

    anchor = _anchor(ANCHOR_118["case118"])
    case = load_case(anchor["case"])
    nlp = acopf.acopf_polar(case)
    theta = acopf.load_scenarios(case, anchor["batch"], seed=anchor["seed"], spread=anchor["spread"])
    trips = []
    pre, block_solver = qp_ipm._pre, qp_ipm.DenseOp.block_solver

    def capture_pre(sl, lop, call, t, cap, staged):
        # a trip's ``prepare`` arguments, from the stretch that computes them
        out = pre(sl, lop, call, t, cap, staged)
        if not trips or trips[0]["op"] is lop:
            args = (out[t + "diag_k"], out[t + "invE_soft"], out[t + "stiff"],
                    out[t + "E_stiff"], sl["st.delta"])
            trips.append({"op": lop, "args": tuple(a.clone() for a in args)})
        return out

    def capture_block(op, *args):
        solve_block, delta = block_solver(op, *args)
        trip = trips[-1]
        if trip["op"] is not op:
            return solve_block, delta

        def first_solve(r1, r2):
            trip.setdefault("rhs", (r1.clone(), r2.clone()))
            return solve_block(r1, r2)

        return first_solve, delta

    # plain calls, so that the hooks run on every trip
    plans = qp_ipm._PLANS
    graphs = plans.graphs
    plans.graphs, qp_ipm._pre, qp_ipm.DenseOp.block_solver = False, capture_pre, capture_block
    try:
        make_batch_solver(nlp, Parameters(**dict(anchor["params"], max_iter=1)))(
            batch_data(nlp, anchor["batch"], theta=theta))
    finally:
        plans.graphs, qp_ipm._pre, qp_ipm.DenseOp.block_solver = graphs, pre, block_solver
    torch.cuda.synchronize()
    # a lane that has left the loop keeps its state bit for bit, so its
    # arguments repeat: keep the trips before the first lane leaves
    kept = [trips[0]]
    for trip in trips[1:]:
        if "rhs" not in trip or not bool((trip["args"][0] != kept[-1]["args"][0]).any(-1).all().item()):
            break
        kept.append(trip)
    return kept


def device_busy_ms(torch, fn, reps=3):
    """Device time of one ``fn()`` (every kernel's time under
    ``torch.profiler`` summed, over ``reps`` calls, per call), after one
    warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def run_plane_trip118(torch, record, card):
    """Phase 18: one KKT trip (``DenseOp.prepare`` and one ``solve_block``)
    of real case118 b16 under the float32 matrix plane and under
    ``mixed_ir``, timed and compared with a float64 solve of the same system."""
    import dataclasses

    import numpy as np

    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile
    from sqpsolver_tpu_torch.ops.qp_ipm import DenseOp

    trips = capture_case118_kkt(torch)
    base = trips[0]["op"]
    Q, A = base.Q, base.A
    B, m, n = A.shape
    log(f"plane_trip118: case118 n={n} m={m} batch={B}, the first {len(trips)} IPM trips (every "
        f"lane still iterating) of the first QP at the start point; Schur cap {base.opts.schur_cap}, ir_steps {base.ir_steps}, "
        f"kkt_backend {base.opts.kkt_backend}")
    out = {}
    for label, trip in ((f"first (1 of {len(trips)})", trips[0]),
                        (f"last ({len(trips)} of {len(trips)})", trips[-1])):
        diag_k, invE_soft, stiff, E_stiff, delta0 = trip["args"]
        r1, r2 = trip["rhs"]
        K = Q + torch.diag_embed(diag_k) + torch.matmul(A.transpose(-1, -2) * invE_soft[:, None, :], A)
        A_t = torch.where(stiff[:, :, None], A, 0.0)
        row = {"n_stiff_max": int(stiff.sum(-1).max().item())}
        for prec in ("mixed_plane", "mixed_ir"):
            op = DenseOp(Q, A, dataclasses.replace(base.opts, plane=prec == "mixed_plane"),
                         torch.float64)

            def trip_fn(op=op):
                solve_block, delta = op.prepare(diag_k, invE_soft, stiff, E_stiff, delta0)
                return (*solve_block(r1, r2), delta)

            launches0 = chol_tile.launches
            dp, dy, delta = trip_fn()
            launched = chol_tile.launches - launches0
            # the float64 system this path solves, solved by LAPACK on the
            # host: its ladder's delta acts on K's diagonal (the plane takes
            # that diagonal from its float32 assembly, which moves the target
            # by delta times its rounding)
            Kd = K + torch.diag_embed(delta[:, None] * torch.diagonal(K, dim1=-2, dim2=-1).abs())
            KKT = torch.cat([torch.cat([Kd, A_t.transpose(-1, -2)], -1),
                             torch.cat([A_t, -torch.diag_embed(E_stiff)], -1)], -2)
            rhs = torch.cat([r1, r2], -1)
            x = torch.as_tensor(np.linalg.solve(KKT.cpu().numpy(), rhs.cpu().numpy()[..., None])[..., 0],
                                device=rhs.device)
            err_p = ((dp - x[:, :n]).abs().max() / x[:, :n].abs().max()).item()
            err_y = ((dy - x[:, n:]).abs().max() / x[:, n:].abs().max()).item()
            v = torch.cat([dp, dy], -1)
            resid = ((torch.matmul(KKT, v.unsqueeze(-1)).squeeze(-1) - rhs).abs().max()
                     / rhs.abs().max()).item()
            times = []
            for _ in range(7):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                trip_fn()
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop))
            row[prec] = {"ms": statistics.median(times), "device_busy_ms": device_busy_ms(torch, trip_fn),
                         "err_dp": err_p, "err_dy": err_y, "residual": resid,
                         "delta_max": float(delta.max().item()),
                         "chol_tile_launches": launched}
            r = row[prec]
            log(f"plane_trip118 {label} trip on {card}: {prec}: prepare + one solve_block "
                f"{r['ms']:.3f} ms between events (median of 7), device busy "
                f"{r['device_busy_ms']:.3f} ms; rel. error against float64 dp {err_p:.3e} dy "
                f"{err_y:.3e}, residual {resid:.3e} of max|rhs|; delta max "
                f"{r['delta_max']:.3e}; {launched} chol_tile launches")
            if not bool(v.isfinite().all().item()):
                raise AssertionError(f"plane_trip118: {prec} gave a non-finite solve")
        pl, ir = row["mixed_plane"], row["mixed_ir"]
        busy = (f"{pl['device_busy_ms'] / ir['device_busy_ms']:.3f}" if ir["device_busy_ms"] > 0
                else "not measured (the profiler saw no device time)")
        log(f"plane_trip118 {label} trip: plane / mixed_ir: {pl['ms'] / ir['ms']:.3f} of the time "
            f"between events, {busy} of the device time; up to {row['n_stiff_max']} stiff rows")
        out[label] = row
    record["plane_trip118"] = out


# ---------------------------------------------------------------------------
# phase 19 (``pegase``): pegase-scale replicated networks, structured path
# ---------------------------------------------------------------------------

#: the replicated networks' JAX anchors (``scripts/torch_anchor.py --replicated``)
ANCHOR_REPLICATED = "anchor_replicated.json"
PEGASE_K = 12  # case118x12: 1,416 buses, n=4128 (pegase-1354 scale)
#: objective / (k x the single network's optimum): replicating the single
#: optimum is feasible, and the ties buy at most ~2%
#: (``tests/test_structured.py:235-237``'s certificate)
PEGASE_BAND = (0.98, 1.0 + 1.0e-3)
PRIM_TOL = 1.0e-6  # prim_infeas of a solved lane (the solve's tol_infeas)
ITERATE_OBJ_RTOL = 1.0e-8  # two float64 SQP iterations against JAX's: objective
ITERATE_X_RTOL = 1.0e-6  # ... and max|dx| / max|x|
#: case30x10's presolve after one SQP iteration against JAX's: max|d| / max|ref|
#: of x0 and lam0 (1.1e-9 and 8.7e-14 on a CPU; the default ``eigh`` shift's
#: float32 rounding parts the two packages from the second iteration on)
PRESOLVE_RTOL = 1.0e-8
#: (b)'s iteration limit: ``pegase_solve.py``'s 40 leaves case118x12 at
#: prim_infeas 1.1e-5 on the H100
PEGASE_MAX_ITER = 100


def replicated_nlp(base, k):
    """``k`` interconnected copies of ``base`` (``models/power.replicate_case``)
    as a one-lane polar ACOPF NLP."""
    from sqpsolver_tpu_torch.models.acopf import acopf_polar
    from sqpsolver_tpu_torch.models.matpower import load_case
    from sqpsolver_tpu_torch.models.power import case9, replicate_case

    case = replicate_case(case9() if base == "case9" else load_case(base), k)
    return case, acopf_polar(case, scenario_batchable=False)


def block_partition(nlp, kkt_parts=0):
    """The block structure ``make_solver`` builds for ``nlp`` (the same call):
    a summary (P, nd, ns, the per-part stiff cap, the stiff Schur size
    nS = P x cap, the coloring widths and the host seconds of the build) and
    the structure itself."""
    import numpy as np

    from sqpsolver_tpu_torch.ops.kkt_bbd import part_schur_cap
    from sqpsolver_tpu_torch.structure import build_block_structure

    g_l, g_u = np.asarray(nlp.g_l, dtype=np.float64), np.asarray(nlp.g_u, dtype=np.float64)
    t0 = time.perf_counter()
    bs = build_block_structure(nlp.n, nlp.m, nlp.structure, np.isfinite(g_l) & (g_l == g_u),
                               n_parts=kkt_parts or None)
    seconds = time.perf_counter() - t0
    cap = part_schur_cap(bs)
    return dict(P=bs.P, nd=bs.nd, ns=bs.ns, cap_p=cap, nS=bs.P * cap,
                nJ=int(bs.colorJ.max()) + 1, nH=int(bs.colorH.max()) + 1,
                seconds=seconds), bs


def panel_launches(nS):
    """``chol_tile`` launches of one ``cholesky_blocked`` factorization of an
    nS-row matrix: one per 128-panel."""
    return -(-nS // 128)


def lane_failures(tag, status, prim):
    """A lane that must end solved: status 0, 1 or 6 and ``prim_infeas`` at
    most ``PRIM_TOL``."""
    if status in (0, 1, 6) and prim <= PRIM_TOL:
        return []
    return [f"{tag}: status {status}, prim_infeas {prim:.3e} (solved: status 0/1/6 and "
            f"prim_infeas <= {PRIM_TOL:g})"]


def band_failures(tag, obj, k, single):
    """The objective must lie in ``PEGASE_BAND`` x k x the single optimum."""
    ratio = obj / (k * single)
    if PEGASE_BAND[0] <= ratio <= PEGASE_BAND[1]:
        return []
    return [f"{tag}: objective {obj:.10g} is {ratio:.6f} of {k} x {single}, outside "
            f"[{PEGASE_BAND[0]}, {PEGASE_BAND[1]}]"]


def anchor_failures(tag, status, obj, want):
    """End in the JAX anchor's status, within ``OBJ_RTOL`` of its objective."""
    rel = abs(obj - want["obj"]) / max(1.0, abs(want["obj"]))
    if status == want["status"] and rel <= OBJ_RTOL:
        return []
    return [f"{tag}: status {status} objective {obj:.10g}, JAX {want['status']} "
            f"{want['obj']:.10g} (rel. {rel:.3e}, tol {OBJ_RTOL:g})"]


def rel_gap(got, ref):
    """max|got - ref| / max|ref| of two vectors."""
    import numpy as np

    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(got) - ref)) / np.max(np.abs(ref)))


def iterate_gap(obj, x, want):
    """(objective rel. difference, max|dx| / max|x|) of an iterate against
    the JAX package's record ``want``."""
    rel_obj = abs(obj - want["obj"]) / max(1.0, abs(want["obj"]))
    return rel_obj, rel_gap(x, want["x"])


def presolve_failures(tag, x0, lam0, want):
    """A presolve's warm start against the JAX package's: x0 and lam0 each
    within ``PRESOLVE_RTOL`` (max|d| / max|ref|).  Returns the failures and
    the two gaps."""
    gaps = dict(x=rel_gap(x0, want["x"]), lam=rel_gap(lam0, want["lam"]))
    return [f"{tag}: {key} max|d|/max|ref| {gap:.3e} (tol {PRESOLVE_RTOL:g})"
            for key, gap in gaps.items() if not gap <= PRESOLVE_RTOL], gaps


def iterate_failures(tag, obj, x, want):
    """An iterate against the JAX package's at the same SQP iteration:
    objective within ``ITERATE_OBJ_RTOL``, max|dx| / max|x| within
    ``ITERATE_X_RTOL``."""
    rel_obj, rel_x = iterate_gap(obj, x, want)
    if rel_obj <= ITERATE_OBJ_RTOL and rel_x <= ITERATE_X_RTOL:
        return []
    return [f"{tag}: objective rel. {rel_obj:.3e} (tol {ITERATE_OBJ_RTOL:g}), max|dx|/max|x| "
            f"{rel_x:.3e} (tol {ITERATE_X_RTOL:g}) against the JAX iterate"]


def launch_failures(tag, launches, calls, nS):
    """The kernel path: launches > 0, and ``panel_launches(nS)`` per
    factorization."""
    per = panel_launches(nS)
    if launches > 0 and launches == calls * per:
        return []
    return [f"{tag}: {launches} chol_tile launches over {calls} factorizations of S "
            f"({nS} rows): not a positive {per} per factorization"]


def agree_failures(tag, obj_a, obj_b):
    """Two solves of one instance: objectives within ``OBJ_RTOL``."""
    rel = abs(obj_a - obj_b) / max(1.0, abs(obj_b))
    return [] if rel <= OBJ_RTOL else [f"{tag}: objectives {obj_a:.10g} and {obj_b:.10g} "
                                       f"differ by {rel:.3e} (tol {OBJ_RTOL:g})"]


def pegase_lane(torch, nlp, params_kw, device="cuda", out=log, tag="pegase", progress=None,
                rescue_fallback=True):
    """One lane of ``nlp`` through ``make_chunked_batch_solver`` on
    ``device``, as ``scripts/pegase_solve.py`` drives the chip; every
    counter is read around the solve (``progress``: the solver's per-round
    log).  Returns the lane's result and the counts."""
    import resource

    from sqpsolver_tpu_torch import Parameters, batch_data, make_chunked_batch_solver
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.ops.chol_blocked import chol_tile, cholesky_blocked
    from sqpsolver_tpu_torch.ops.qp_ipm import solve_qp

    card = torch.device(device).type == "cuda"
    params = Parameters(**params_kw)
    t0 = time.perf_counter()
    solver = make_chunked_batch_solver(nlp, params, rescue_fallback=rescue_fallback, log=progress)
    build_s = time.perf_counter() - t0
    data = batch_data(nlp, 1, device=device)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    chol_tile.launches = 0
    calls0, syncs0 = cholesky_blocked.calls, any_lane.syncs
    trips0, secs0 = dict(solve_qp.loop_trips), dict(solve_qp.phase_seconds)
    t0 = time.perf_counter()
    res = solver(data)
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = dict(solver.stats)
    trips = {p: solve_qp.loop_trips[p] - trips0[p] for p in trips0}
    secs = {p: solve_qp.phase_seconds[p] - secs0[p] for p in secs0}
    rounds = stats["rounds"] + stats["fallback_rounds"]
    r = dict(
        status=int(res.status[0]), iterations=int(res.iterations[0]),
        obj=float(res.obj_val[0]), prim=float(res.prim_infeas[0]),
        x=res.x[0].cpu().numpy(), x_finite=bool(torch.isfinite(res.x).all()),
        qp_trips=int(res.qp_iters_total[0]), wall=wall, build_s=build_s,
        trips=trips, secs=secs, rounds=rounds, syncs=any_lane.syncs - syncs0 + rounds,
        launches=chol_tile.launches, calls=cholesky_blocked.calls - calls0,
        fallback=bool(stats["fallback_lanes"]),
        peak_gb=torch.cuda.max_memory_allocated() / 2**30 if card else None,
        rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
    )
    per_trip = {p: secs[p] / trips[p] if trips[p] else 0.0 for p in secs}
    out(f"{tag}: status {r['status']} obj {r['obj']:.10g} in {r['iterations']} SQP iterations "
        f"({r['qp_trips']} QP trips), inf_pr {r['prim']:.3e}, wall {wall:.3f} s (solver built "
        f"in {build_s:.3f} s); batched IPM trips phase 1 {trips[1]} ({per_trip[1] * 1e3:.1f} ms "
        f"of host time each), phase 2 {trips[2]} ({per_trip[2] * 1e3:.1f} ms each); "
        f"{r['syncs']} host syncs ({rounds} rounds); {r['launches']} chol_tile launches over "
        f"{r['calls']} kernel-route factorizations; fallback {'taken' if r['fallback'] else 'not taken'}; "
        f"peak device memory "
        + (f"{r['peak_gb']:.3f} GiB" if card else "not measured (CPU run)")
        + f", peak host RSS {r['rss_gb']:.3f} GiB")
    return r


#: the profiler's matrix-product ops: where a bus-sum incidence product runs
MATRIX_PRODUCT_OPS = ("aten::mm", "aten::mv", "aten::matmul", "aten::addmm", "aten::bmm")


def incidence_product(name, shapes, nb, widths):
    """Whether a profiler op is a bus-sum incidence product: a matrix
    product with an (nb, w) operand, or its transpose, for a ``w`` of
    ``widths`` (the generator and branch counts)."""
    pairs = {tuple(sorted((nb, w))) for w in widths}
    return name in MATRIX_PRODUCT_OPS and any(
        len(sh) >= 2 and tuple(sorted(sh[-2:])) in pairs for sh in shapes or [])


def derivative_probe(torch, nlp, case, part, bs):
    """One structured derivative evaluation at the start point on the card:
    its time (CUDA events), peak device memory, and the share of its device
    time spent in the bus-sum incidence products (``torch.profiler``: the
    matrix products that take an (nb, ng) or (nb, nl) incidence matrix,
    ``incidence_product``)."""
    from torch.profiler import ProfilerActivity, profile

    from sqpsolver_tpu_torch.algorithms.sqp_tr import structured_derivatives
    from sqpsolver_tpu_torch.ops.kkt_bbd import BlockMaps
    from sqpsolver_tpu_torch.parallel.batch import batch_data

    maps = BlockMaps(bs, torch.device("cuda"))
    data = batch_data(nlp, 1)
    lam = torch.zeros((1, nlp.m), dtype=data.x0.dtype, device="cuda")

    def once():
        return structured_derivatives(nlp, maps, data.x0, lam, data.theta)

    once()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    once()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        once()
        torch.cuda.synchronize()
    total = inc = 0.0
    widths = (len(case.gen_bus), len(case.br_f))
    for avg in prof.key_averages(group_by_input_shape=True):
        dev = getattr(avg, "self_device_time_total", None)
        dev = avg.self_cuda_time_total if dev is None else dev
        total += dev
        if incidence_product(avg.key, avg.input_shapes, case.nb, widths):
            inc += dev
    share = inc / total if total else None
    log(f"pegase: structured derivatives at n={nlp.n}: nJ={part['nJ']} JVPs and "
        f"nH={part['nH']} forward-over-reverse HVPs per lane, {ms:.3f} ms (CUDA events), "
        f"peak device memory above the inputs {peak_gb:.3f} GiB; bus-sum incidence products "
        + (f"{share:.2%} of its device time ({inc / 1e3:.3f} of {total / 1e3:.3f} ms)"
           if share is not None else "not measured (the profiler saw no device time)"))
    return dict(ms=ms, peak_gb=peak_gb, incidence_share=share)


def pegase_full(torch, nlp, k, anchor, out=log, progress=None):
    """The whole solves of one replicated case118 lane on the card: (a) the
    kernel path (the structured bench configuration, rescue fallback on) and
    (b) ``pegase_solve.py``'s parameters at ``PEGASE_MAX_ITER``.  Returns
    both results and the failures of their gates: each solved, within
    ``PEGASE_BAND``, the two within ``OBJ_RTOL`` of each other, and the
    kernel at ``panel_launches(nS)`` per factorization."""
    from sqpsolver_tpu_torch.models.matpower import VENDORED_OPTIMA

    single = VENDORED_OPTIMA["case118"]
    nS = block_partition(nlp)[0]["nS"]
    a = pegase_lane(torch, nlp, anchor["bench_params"], out=out, progress=progress,
                    tag=f"case118x{k} (a) kernel path")
    b = pegase_lane(torch, nlp, dict(anchor["pegase_params"], max_iter=PEGASE_MAX_ITER), out=out,
                    progress=progress, tag=f"case118x{k} (b) pegase_solve.py parameters")
    failures = launch_failures("(a)", a["launches"], a["calls"], nS)
    for tag, r in (("(a)", a), ("(b)", b)):
        failures += lane_failures(tag, r["status"], r["prim"])
        failures += band_failures(tag, r["obj"], k, single)
        if not r["x_finite"]:
            failures.append(f"{tag}: x is not finite")
    failures += agree_failures("(a) and (b)", a["obj"], b["obj"])
    out(f"case118x{k}: band ratios (obj / {k} x {single}): (a) {a['obj'] / (k * single):.6f}, "
        f"(b) {b['obj'] / (k * single):.6f} (band {PEGASE_BAND}); (a) and (b) rel. "
        f"{abs(a['obj'] - b['obj']) / abs(b['obj']):.3e} (tol {OBJ_RTOL:g})")
    return a, b, failures


def run_pegase(torch, record):
    """Phase 19: pegase-scale replicated networks through the structured path
    on the card, held to the JAX package (``anchor_replicated.json``).  The
    whole solves of case118x12 (``pegase_full``, ~15 min on the H100) do not
    fit this script's time limit beside the other paths: they are
    ``scripts/torch_pegase_solve.py 12 --both``; here the kernel path runs
    its float32 first pass."""
    import sqpsolver_tpu_torch as tp
    from sqpsolver_tpu_torch.models.matpower import VENDORED_OPTIMA
    from sqpsolver_tpu_torch.utils.warmstart import presolve_start

    anchor = _anchor(ANCHOR_REPLICATED)
    t_phase = time.perf_counter()
    case, nlp = replicated_nlp("case118", PEGASE_K)
    part, bs = block_partition(nlp)
    want = anchor["structure"][f"case118x{PEGASE_K}"]
    log(f"pegase: {case.name} ({case.nb} buses, n={nlp.n}, m={nlp.m}): P={part['P']} parts of "
        f"nd={part['nd']}, separator ns={part['ns']}, stiff cap {part['cap_p']} per part, "
        f"stiff Schur nS={part['nS']} ({panel_launches(part['nS'])} panels), nJ={part['nJ']}, "
        f"nH={part['nH']}, structure built in {part['seconds']:.3f} s on the host; JAX: "
        f"P={want['P']} nd={want['nd']} ns={want['ns']} cap {want['cap_p']} nS={want['nS']}")
    failures = [f"partition: {key} {part[key]} against JAX's {want[key]}"
                for key in ("P", "nd", "ns", "cap_p", "nS", "nJ", "nH") if part[key] != want[key]]
    if part["nS"] != PEGASE_NS:
        failures.append(f"partition: nS {part['nS']}, phases 3-4 time {PEGASE_NS}")
    derivative_probe(torch, nlp, case, part, bs)

    # (a) the kernel path's float32 first pass: chol_tile on the stiff S
    a = pegase_lane(torch, nlp, anchor["bench_params"], rescue_fallback=False,
                    tag="pegase (a) kernel path, first pass")
    record["launches"] += a["launches"]
    record["launches_by_path"][f"pegase_x{PEGASE_K}"] = a["launches"]
    record["launches_per_factorization"]["pegase"] = a["launches"] / max(a["calls"], 1)
    failures += launch_failures("(a)", a["launches"], a["calls"], part["nS"])
    if not a["x_finite"]:
        failures.append("(a): x is not finite")

    # (b) scripts/pegase_solve.py's parameters, two SQP iterations, against
    # the JAX package's iterate
    want2 = anchor[f"case118x{PEGASE_K}_iter2"]
    b2 = pegase_lane(torch, nlp, dict(anchor["pegase_params"], max_iter=2),
                     tag="pegase (b) two iterations")
    failures += iterate_failures("(b) two iterations", b2["obj"], b2["x"], want2)
    rel2, dx2 = iterate_gap(b2["obj"], b2["x"], want2)
    log(f"pegase: (b) after two iterations: objective {b2['obj']:.12g} against JAX's "
        f"{want2['obj']:.12g} (rel. {rel2:.3e}, tol {ITERATE_OBJ_RTOL:g}), max|dx|/max|x| "
        f"{dx2:.3e} (tol {ITERATE_X_RTOL:g}); JAX took {want2['seconds_with_compile']} s on the CPU")

    # (c) one-lane float64 structured solves through optimize
    _, nlp4 = replicated_nlp("case118", 4)
    res = tp.optimize(nlp4, tp.Parameters(**anchor["pegase_params"]))
    w4 = anchor["case118x4"]
    log(f"pegase: (c) case118x4 (n={nlp4.n}): {res.status_name} obj {res.obj_val:.10g} in "
        f"{res.iterations} iterations ({res.qp_iters_total} QP trips), inf_pr "
        f"{res.prim_infeas:.3e}, wall {res.solve_time:.3f} s; JAX "
        f"{tp.status_name(w4['status'])} {w4['obj']:.10g} in {w4['iterations']} iterations "
        f"({w4['seconds_with_compile']} s on the CPU)")
    failures += anchor_failures("(c) case118x4", int(res.status), res.obj_val, w4)
    # ten copies of case30, presolve then structured: the test's flow (the
    # default eigh shift, whose float32 eigenvalue estimate rounds
    # differently in another LAPACK, so the loose presolve stops elsewhere:
    # held to the test's own certificate) and with the float64 ladder shift
    # (held to JAX's objective)
    case30x10, nlp30 = replicated_nlp("case30", 10)
    # the test's flow where the two packages still agree: its presolve's
    # first iterate
    first = presolve_start(nlp30, tp.Parameters(**anchor["case30x10_params"]), max_iter=1)
    bad, gaps = presolve_failures("(c) case30x10 presolve, first iterate",
                                  first.x0[0].cpu().numpy(), first.lam0[0].cpu().numpy(),
                                  anchor["case30x10_presolve1"])
    failures += bad
    log(f"pegase: (c) case30x10 presolve after one SQP iteration against JAX's: max|dx|/max|x| "
        f"{gaps['x']:.3e}, max|dlam|/max|lam| {gaps['lam']:.3e} (tol {PRESOLVE_RTOL:g})")
    for name, shift in (("case30x10", {}), ("case30x10_ladder", {"hessian_shift": "ladder"})):
        params = tp.Parameters(**dict(anchor["case30x10_params"], **shift))
        t0 = time.perf_counter()
        warm = presolve_start(nlp30, params)
        raw = tp.make_solver(nlp30, params.replace(kkt_structured=True))(warm)
        torch.cuda.synchronize()
        res = tp.from_raw(raw, time.perf_counter() - t0)
        want = anchor[name]
        rel = abs(res.obj_val - want["obj"]) / abs(want["obj"])
        log(f"pegase: (c) {name} ({case30x10.nb} buses, n={nlp30.n}), presolve then "
            f"structured: {res.status_name} obj {res.obj_val:.10g} in {res.iterations} iterations, "
            f"inf_pr {res.prim_infeas:.3e}, wall {res.solve_time:.3f} s; JAX "
            f"{tp.status_name(want['status'])} {want['obj']:.10g} in {want['iterations']} "
            f"iterations ({want['seconds_with_compile']} s on the CPU), rel. {rel:.3e}")
        if shift:
            failures += anchor_failures(f"(c) {name}", int(res.status), res.obj_val, want)
        else:
            if int(res.status) != want["status"]:
                failures.append(f"(c) {name}: status {int(res.status)}, JAX {want['status']}")
            failures += lane_failures(f"(c) {name}", int(res.status), res.prim_infeas)
            failures += band_failures(f"(c) {name}", res.obj_val, 10, VENDORED_OPTIMA["case30"])
    log(f"pegase: phase 19 in {time.perf_counter() - t_phase:.3f} s")
    if failures:
        raise AssertionError("pegase: " + "; ".join(failures))


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument(
        "--paths", default=",".join(PATHS),
        help=f"the paths to drive (default all: {','.join(PATHS)}; a partial run prints no "
             "closing ok line)",
    )
    args = ap.parse_args()
    paths = args.paths.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = card_line()
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
    record["blocked"] = check_blocked(torch, chol_blocked, card)
    wall_ir = None
    if "case30" in paths:
        wall_ir = run_slice(torch, record)
    if "case118" in paths:
        run_case118(torch, record)
    if "single" in paths:
        run_single(torch, record)
    if "ls_case30" in paths:
        run_ls_case30(torch, record)
    if "structured118" in paths:
        run_case118(torch, record, "structured118")
    if "structured_single" in paths:
        run_structured_single(torch, record)
    if "rect118" in paths:
        run_case118(torch, record, "rect118")
    if "forms_single" in paths:
        run_forms_single(torch, record)
    if "sharded" in paths:
        run_sharded(torch, record, card)
    if "multihost" in paths:
        run_multihost(torch, record, card)
    if "block_sharded" in paths:
        run_block_sharded(torch, record, card)
    if "plane_case30" in paths:
        run_plane_case30(torch, record, card, wall_ir)
    if "plane_trip118" in paths:
        run_plane_trip118(torch, record, card)
    if "pegase" in paths:
        run_pegase(torch, record)
    for batch, n in SLICE_SHAPES + SHARDED_SHAPES + PANEL_SHAPES + (STRUCTURED_PANEL,) + PEGASE_PANELS:
        t = record["timings"][f"{batch}x{n}x{n}"]
        log(f"chol_tile ({batch},{n},{n}) on {card}: {t['bound_ms'] / t['ms']:.2%} of "
            f"its bound, {t['ms'] / t['library_ms']:.3f} of the library call's time")
    log(json.dumps({"kernels": [record]}))
    log(card)
    if sorted(paths) != sorted(PATHS):
        log(json.dumps({"ok": False, "reason": f"partial run: paths {paths}"}))
        return 0
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
