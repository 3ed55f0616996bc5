"""The float64 phase 2 of the port's interior-point solver (the stall rescue
and ``mixed_polish``) against the JAX package's ``solve_qp`` under ``vmap``.

Six seeded QPs shaped like ``tests/test_torch_qp.py``'s go through both
packages with float32 factors in phase 1 (``factor_dtype="float32"``, library
Cholesky on both sides): two lanes carry an ill-conditioned Q (cond 1e9, in a
random basis so that equilibration cannot undo it), one lane is skipped, four
are warm-started.  Phase 1 is given 20 trips, which the hard lane 0 and the
warm-started lane 5 do not finish in: they leave it unconverged and restart
phase 2 from the cold point.  Lane 5 then converges within the rescue's 28
trips; lane 0 needs 35, which only the polish budget of 40 holds.

* ``rescue``: ``polish_iters=8`` at ``tol=2e-6`` with a capped Schur set, the
  options ``qp_rescue=True`` gives a ``mixed_ir`` solve.  ``converged`` equal
  lane by lane; ``p`` and ``y`` of the converged lanes within 1e-5 relative
  (lanes that finish in the float32 phase differ by its rounding, as in
  ``test_torch_qp.py``), and within 1e-7 on the lanes that finished in
  float64.
* ``polish``: ``polish_iters=20`` at ``tol=1e-8`` (strict: every lane goes on
  in float64 and the cap is lifted): ``p`` and ``y`` within 1e-7 relative.
* Lanes that phase 1 converged strictly, and the skipped lane, take no
  phase-2 trip: every field of theirs is bit-identical to a run with
  ``polish_iters=0``.
* A warm-started lane that leaves phase 1 unconverged restarts from the cold
  point: its solution is bit-identical to that of the same lane started cold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqpsolver_tpu.ops import qp_ipm as j_qp
from sqpsolver_tpu_torch.ops import qp_ipm as t_qp

INF = np.inf
N, M, B = 10, 14, 6
HARD = (0, 3)
SKIPPED = 4
FIELDS = ("p", "y", "mult_lo", "mult_up", "slack_u", "slack_v", "iters", "converged",
          "pri_res", "dual_res", "gap")


def _qps(seed=1):
    rng = np.random.default_rng(seed)
    Q, c, A, rl, ru, lb, ub = [], [], [], [], [], [], []
    for lane in range(B):
        if lane in HARD:
            U, _ = np.linalg.qr(rng.standard_normal((N, N)))
            Q.append(U @ np.diag(np.logspace(-4, 5, N)) @ U.T)
        else:
            L = rng.standard_normal((N, N)) / np.sqrt(N)
            Q.append(L @ L.T + 0.1 * np.eye(N))
        c.append(rng.standard_normal(N))
        Ai = rng.standard_normal((M, N)) / np.sqrt(N)
        mid = Ai @ (rng.standard_normal(N) * 0.1)
        half = np.abs(rng.standard_normal(M)) + 0.1
        kind = rng.integers(0, 4, M)
        r_l = np.where(kind == 1, -INF, mid - half)
        r_u = np.where(kind == 2, INF, mid + half)
        A.append(Ai)
        rl.append(np.where(kind == 3, r_u, r_l))
        ru.append(r_u)
        lb.append(np.full(N, -2.0))
        ub.append(np.full(N, 2.0))
    arrs = [np.stack(a) for a in (Q, c, A, rl, ru, lb, ub)] + [np.full((B, M), 1e8)]
    skip = np.zeros(B, bool)
    skip[SKIPPED] = True
    init = dict(
        p=rng.standard_normal((B, N)) * 0.1,
        y=rng.standard_normal((B, M)),
        zl=np.abs(rng.standard_normal((B, N))),
        zu=np.abs(rng.standard_normal((B, N))),
        on=np.array([False, True, True, True, True, True]),
    )
    return arrs, skip, init


OPTS = {
    "rescue": dict(factor_dtype="float32", ir_steps=4, invE_floor=3e-7, schur_cap=8,
                   tol=2e-6, max_iter=20, polish_iters=8),
    "polish": dict(factor_dtype="float32", ir_steps=4, invE_floor=3e-7, schur_cap=8,
                   tol=1e-8, max_iter=20, polish_iters=20),
}


def _torch_solve(kw, init_on=None):
    arrs, skip, init = _qps()
    if init_on is not None:
        init = dict(init, on=np.asarray(init_on))
    before = dict(t_qp.solve_qp.loop_trips)
    sol = t_qp.solve_qp(
        *(torch.as_tensor(a) for a in arrs), opts=t_qp.IpmOptions(**kw),
        skip=torch.as_tensor(skip), init={k: torch.as_tensor(v) for k, v in init.items()},
    )
    trips = {k: t_qp.solve_qp.loop_trips[k] - before[k] for k in before}
    return sol, trips


@pytest.fixture(scope="module", params=list(OPTS))
def both(request):
    kw = OPTS[request.param]
    arrs, skip, init = _qps()
    j_opts = j_qp.IpmOptions(**kw)

    def one(Q, c, A, rl, ru, lb, ub, w, sk, ini):
        return j_qp.solve_qp(Q, c, A, rl, ru, lb, ub, w, opts=j_opts, skip=sk, init=ini)

    jsol = jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(skip),
        {k: jnp.asarray(v) for k, v in init.items()},
    )
    tsol, trips = _torch_solve(kw)
    phase1, _ = _torch_solve(dict(kw, polish_iters=0))
    return request.param, jsol, tsol, trips, phase1


def test_phase2_solutions_agree_with_jax(both):
    name, jsol, tsol, trips, phase1 = both
    conv = tsol.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(jsol.converged))
    assert conv.tolist() == [name == "polish", True, True, True, False, True]
    assert trips[2] > 0
    # lanes that ended in the float64 phase: all under strict polish, else
    # those that phase 1 left unconverged
    in_f64 = conv if name == "polish" else conv & ~phase1.converged.numpy()
    assert in_f64.sum() >= 1
    for field in ("p", "y"):
        j = np.asarray(getattr(jsol, field))
        t = getattr(tsol, field).numpy()
        err = np.abs(t - j).max(-1) / np.maximum(1.0, np.abs(j).max(-1))
        assert (err[conv] <= 1e-5).all(), (field, err)
        assert (err[in_f64] <= 1e-7).all(), (field, err)
    np.testing.assert_array_equal(
        tsol.iters.numpy()[SKIPPED], np.asarray(jsol.iters)[SKIPPED]
    )


def test_zero_trip_lanes_keep_phase1_bit_for_bit():
    tsol, _ = _torch_solve(OPTS["rescue"])
    phase1, _ = _torch_solve(dict(OPTS["rescue"], polish_iters=0))
    keep = phase1.converged.numpy().copy()
    keep[SKIPPED] = True
    assert keep.tolist() == [False, True, True, True, True, False]
    for field in FIELDS:
        a = getattr(tsol, field)[torch.as_tensor(keep)]
        b = getattr(phase1, field)[torch.as_tensor(keep)]
        assert torch.equal(a, b), field
    assert int(tsol.iters[SKIPPED]) == 0
    # lane 5 was rescued: unconverged after phase 1, converged after phase 2,
    # with its trip count restarted at the cold point
    assert not bool(phase1.converged[5]) and bool(tsol.converged[5])
    assert int(phase1.iters[5]) == 20 and int(tsol.iters[5]) > 20


def test_stalled_warm_lane_restarts_cold():
    kw = OPTS["rescue"]
    warm, _ = _torch_solve(kw)
    phase1, _ = _torch_solve(dict(kw, polish_iters=0))
    assert not bool(phase1.converged[5])  # the warm start did not get there
    cold, _ = _torch_solve(kw, init_on=[False] * B)
    assert bool(warm.converged[5])
    for field in ("p", "y", "mult_lo", "mult_up", "iters"):
        assert torch.equal(getattr(warm, field)[5], getattr(cold, field)[5]), field


def test_rescue_op_shares_matrices_and_caps():
    Q, A = torch.zeros(1, 3, 3, dtype=torch.float64), torch.zeros(1, 5, 3, dtype=torch.float64)
    op = t_qp.DenseOp(Q, A, t_qp.IpmOptions(factor_dtype="float32", schur_cap=4), torch.float64)
    kept, lifted = op.rescue_op(keep_cap=True), op.rescue_op()
    assert kept.Q is Q and kept.A is A and lifted.A is A
    assert kept.fdtype == torch.float64 and kept.ir_steps == 0
    assert kept.opts.schur_cap == 4 and lifted.opts.schur_cap == 0
