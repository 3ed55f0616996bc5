"""The port's dense elastic IPM against the JAX package's ``solve_qp`` under
``vmap``, on small random QPs shaped like ``tests/test_qp.py``.

* direct float64 factors (``kkt_backend="xla"``: cholesky_ex in the port):
  per-lane IPM iteration counts equal, solution agrees to 1e-8;
* float32 factors through the kernel path (``kkt_backend="pallas"``,
  ``mixed_ir``-style options) with a capped Schur set: solution agrees to
  1e-5 (float32 rounding of the factors differs between the two codes).

Cold starts, warm starts and skipped lanes are in every batch.
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


def _random_qps(seed):
    rng = np.random.default_rng(seed)
    Q, c, A, rl, ru, lb, ub = [], [], [], [], [], [], []
    for lane in range(B):
        L = rng.standard_normal((N, N)) / np.sqrt(N)
        Q.append(L @ L.T + 0.1 * np.eye(N))
        c.append(rng.standard_normal(N))
        Ai = rng.standard_normal((M, N)) / np.sqrt(N)
        p_feas = rng.standard_normal(N) * 0.1
        p_feas[0] = 0.3  # every QP is feasible, with lane 5's fixed variable
        mid = Ai @ p_feas
        half = np.abs(rng.standard_normal(M)) + 0.1
        kind = rng.integers(0, 4, M)
        r_l = np.where(kind == 1, -INF, mid - half)
        r_u = np.where(kind == 2, INF, mid + half)
        r_l = np.where(kind == 3, r_u, r_l)
        A.append(Ai)
        rl.append(r_l)
        ru.append(r_u)
        lo = np.full(N, -2.0)
        hi = np.full(N, 2.0)
        if lane == 5:
            hi[0] = lo[0] = 0.3  # a fixed variable (pinned by the ridge)
        lb.append(lo)
        ub.append(hi)
    arrs = [np.stack(a) for a in (Q, c, A, rl, ru, lb, ub)]
    w = np.full((B, M), 1e8)
    skip = np.zeros(B, bool)
    skip[4] = True
    init = dict(
        p=rng.standard_normal((B, N)) * 0.1,
        y=rng.standard_normal((B, M)),
        zl=np.abs(rng.standard_normal((B, N))),
        zu=np.abs(rng.standard_normal((B, N))),
        on=np.array([False, True, True, False, True, True]),
    )
    return arrs + [w], skip, init


OPTS = {
    "direct_f64_xla": dict(tol=1e-8),
    "f32_pallas_schur_cap": dict(
        factor_dtype="float32", kkt_backend="pallas", ir_steps=4,
        invE_floor=3e-7, schur_cap=8, tol=2e-6, max_iter=30,
    ),
}


@pytest.fixture(scope="module", params=list(OPTS))
def both(request):
    kw = OPTS[request.param]
    arrs, skip, init = _random_qps(4)
    j_opts = j_qp.IpmOptions(**kw)
    t_opts = t_qp.IpmOptions(**kw)

    def one(Q, c, A, rl, ru, lb, ub, w, sk, ini):
        return j_qp.solve_qp(Q, c, A, rl, ru, lb, ub, w, opts=j_opts, skip=sk, init=ini)

    jsol = jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(skip),
        {k: jnp.asarray(v) for k, v in init.items()},
    )
    tsol = t_qp.solve_qp(
        *(torch.as_tensor(a) for a in arrs), opts=t_opts, skip=torch.as_tensor(skip),
        init={k: torch.as_tensor(v) for k, v in init.items()},
    )
    return request.param, jsol, tsol, skip


def test_solutions_agree(both):
    """Converged flags equal lane by lane; the solutions of the lanes that
    converged agree.  (A lane that stops at the precision floor -- here the
    fixed-variable lane in float64 and one hard lane in float32 -- must stop
    unconverged on both sides; its iterate is not a solution to compare.)"""
    name, jsol, tsol, skip = both
    tol = 1e-8 if name == "direct_f64_xla" else 1e-5
    conv = tsol.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(jsol.converged))
    assert conv.sum() >= 4 and not conv[skip].any()
    for field in ("p", "y", "mult_lo", "mult_up"):
        j = np.asarray(getattr(jsol, field))[conv]
        t = getattr(tsol, field).numpy()[conv]
        err = np.abs(t - j).max() / max(1.0, np.abs(j).max())
        assert err <= tol, (field, err)


def test_iteration_counts(both):
    name, jsol, tsol, skip = both
    it_t, it_j = tsol.iters.numpy(), np.asarray(jsol.iters)
    assert (it_t[skip] == 0).all() and (it_j[skip] == 0).all()
    if name == "direct_f64_xla":
        np.testing.assert_array_equal(it_t, it_j)
    else:  # float32 rounding may move a trip; the runs stay alike
        assert np.abs(it_t.astype(int) - it_j).max() <= 2


def test_cap_stiff_ties_break_by_row_index():
    op = t_qp.DenseOp(torch.zeros(1, 2, 2), torch.zeros(1, 6, 2), t_qp.IpmOptions(), torch.float64)
    E = torch.tensor([[0.5, 0.1, 0.1, torch.nan, 0.1, 0.2]], dtype=torch.float64)
    stiff = torch.tensor([[True, True, True, True, True, False]])
    got = op.cap_stiff(stiff, E, 3)
    assert got.tolist() == [[False, True, True, False, True, False]]
    assert op.cap_stiff(stiff, E, 2).tolist() == [[False, True, True, False, False, False]]
