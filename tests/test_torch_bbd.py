"""The port's block-structured (BBD) KKT pieces against the JAX package's
``ops/kkt_bbd.py``, on the CPU, with the same numpy-seeded inputs.

* ``bbd_factorize`` / ``bbd_solve`` on a random SPD BBD system (P=3, nd=8,
  ns=5): against the JAX pair and a dense solve, float64 at 1e-12 and
  float32 at 1e-5 relative.
* An indefinite interior that forces the ladder and the bisection: the
  port's ``delta`` is exactly JAX's, lane by lane.
* ``BlockMaps`` gathers and block matvecs on case9: against JAX's blocks and
  the dense Jacobian / Hessian at 1e-12.
* ``BbdOperator.prepare``'s ``solve_block`` on one case9 IPM state with
  float64 factors: against JAX's at 1e-10.
* The per-part stiff slots with tied E values: JAX's ``lax.top_k`` set and
  order, from the port's stable sort.
* One structured QP through ``solve_qp_op`` (float64 and mixed factors):
  JAX's trip count, and its solution at the factor dtype's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import power as j_power
from sqpsolver_tpu.ops import kkt_bbd as j_bbd
from sqpsolver_tpu.ops import qp_ipm as j_qp
from sqpsolver_tpu.structure import build_block_structure as j_build
from sqpsolver_tpu_torch.algorithms.sqp_tr import structured_derivatives
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import power as t_power
from sqpsolver_tpu_torch.ops import kkt_bbd as t_bbd
from sqpsolver_tpu_torch.ops import qp_ipm as t_qp
from sqpsolver_tpu_torch.structure import build_block_structure as t_build



def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _random_bbd(rng, P=3, nd=8, ns=5):
    Bs = rng.standard_normal((P, nd, nd))
    K_pp = Bs @ np.swapaxes(Bs, 1, 2) + nd * np.eye(nd)
    K_ps = rng.standard_normal((P, nd, ns))
    C = rng.standard_normal((ns, ns))
    K_ss = C @ C.T + (nd * P) * np.eye(ns)
    return K_pp, K_ps, K_ss


def _dense(K_pp, K_ps, K_ss):
    P, nd, _ = K_pp.shape
    ns = K_ss.shape[0]
    Kd = np.zeros((P * nd + ns, P * nd + ns))
    for p in range(P):
        sl = slice(p * nd, (p + 1) * nd)
        Kd[sl, sl] = K_pp[p]
        Kd[sl, P * nd:] = K_ps[p]
        Kd[P * nd:, sl] = K_ps[p].T
    Kd[P * nd:, P * nd:] = K_ss
    return Kd


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_bbd_factorize_solve_random(dtype, tol):
    rng = np.random.default_rng(7)
    K_pp, K_ps, K_ss = _random_bbd(rng)
    r_pp = rng.standard_normal((3, 8))
    r_ss = rng.standard_normal(5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jf = j_bbd.bbd_factorize(*(jnp.asarray(a, jd) for a in (K_pp, K_ps, K_ss)), 0.0)
    jx_pp, jx_ss = j_bbd.bbd_solve(jf, jnp.asarray(r_pp, jd), jnp.asarray(r_ss, jd))
    tf = t_bbd.bbd_factorize(
        *(torch.as_tensor(a, dtype=td)[None] for a in (K_pp, K_ps, K_ss)),
        torch.zeros(1, dtype=td),
    )
    assert bool(tf.ok[0]) and bool(jf.ok)
    tx_pp, tx_ss = t_bbd.bbd_solve(
        tf, torch.as_tensor(r_pp, dtype=td)[None], torch.as_tensor(r_ss, dtype=td)[None]
    )
    got = np.concatenate([tx_pp[0].numpy().ravel(), tx_ss[0].numpy()])
    want = np.concatenate([np.asarray(jx_pp).ravel(), np.asarray(jx_ss)])
    assert _rel(got, want) <= tol
    ref = np.linalg.solve(_dense(K_pp, K_ps, K_ss), np.concatenate([r_pp.ravel(), r_ss]))
    assert _rel(got, ref) <= (1e-12 if dtype == "float64" else 1e-4)
    # panel right-hand sides take the same route
    R_pp = rng.standard_normal((3, 8, 4))
    R_ss = rng.standard_normal((5, 4))
    jX = j_bbd.bbd_solve(jf, jnp.asarray(R_pp, jd), jnp.asarray(R_ss, jd))
    tX = t_bbd.bbd_solve(tf, torch.as_tensor(R_pp, dtype=td)[None], torch.as_tensor(R_ss, dtype=td)[None])
    for a, b in zip(tX, jX):
        assert _rel(a[0].numpy(), b) <= tol


@pytest.mark.parametrize("dtype,min_pivot", [("float64", 0.0), ("float32", 1e-3)])
def test_bbd_ladder_and_bisection_give_jax_delta(dtype, min_pivot):
    """Lane 0: an interior with eigenvalue -0.37 (ladder from the floor up,
    then bisection); lane 1: SPD (no escalation, keeps delta0); lane 2: a
    separator Schur complement that is indefinite."""
    rng = np.random.default_rng(3)
    lanes = []
    for lane in range(3):
        K_pp, K_ps, K_ss = _random_bbd(rng)
        if lane == 0:
            Q, _ = np.linalg.qr(rng.standard_normal((8, 8)))
            K_pp[1] = Q @ np.diag(np.linspace(-0.37, 3.0, 8)) @ Q.T
        if lane == 2:
            K_ss = K_ss - 60.0 * np.eye(5)
        lanes.append((K_pp, K_ps, K_ss))
    delta0 = np.array([0.0, 0.25, 1e-3])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = [
        float(j_bbd.bbd_factorize(*(jnp.asarray(a, jd) for a in lanes[b]), d0, min_pivot).delta)
        for b, d0 in enumerate(delta0)
    ]
    stacked = [torch.as_tensor(np.stack([ln[i] for ln in lanes]), dtype=td) for i in range(3)]
    fact = t_bbd.bbd_factorize(*stacked, torch.as_tensor(delta0, dtype=td), min_pivot)
    got = fact.delta.tolist()
    assert got == want
    assert want[0] > 0.37 and want[1] == pytest.approx(0.25) and want[2] > 1e-3
    assert fact.ok.all()


@pytest.fixture(scope="module")
def case9():
    """case9's block structure in both packages, a point, multipliers, and
    the compressed-AD blocks and dense derivatives there."""
    j_nlp = j_acopf.acopf_polar(j_power.case9(), scenario_batchable=False)
    t_nlp = t_acopf.acopf_polar(t_power.case9(), scenario_batchable=False)
    gl, gu = np.asarray(j_nlp.g_l), np.asarray(j_nlp.g_u)
    eq = np.isfinite(gl) & (gl == gu)
    j_bs = j_build(j_nlp.n, j_nlp.m, j_nlp.structure, eq)
    t_bs = t_build(t_nlp.n, t_nlp.m, t_nlp.structure, eq)
    j_maps, t_maps = j_bbd.BlockMaps(j_bs), t_bbd.BlockMaps(t_bs)
    x = np.asarray(j_nlp.x0) + 0.01
    lam = np.random.default_rng(3).standard_normal(j_nlp.m)
    seedsJ = np.zeros((j_bs.nJ, j_nlp.n))
    seedsJ[j_bs.colorJ, np.arange(j_nlp.n)] = 1.0
    seedsH = np.zeros((j_bs.nH, j_nlp.n))
    seedsH[j_bs.colorH, np.arange(j_nlp.n)] = 1.0

    @jax.jit
    def jax_side(xj, lj):
        lag = lambda z: j_nlp.f(z) + lj @ j_nlp.cons(z)  # noqa: E731
        Jc = jax.vmap(lambda s: jax.jvp(j_nlp.cons, (xj,), (s,))[1])(jnp.asarray(seedsJ))
        Hc = jax.vmap(lambda s: jax.jvp(jax.grad(lag), (xj,), (s,))[1])(jnp.asarray(seedsH))
        return (j_maps.jac_blocks(Jc.T), j_maps.hess_blocks(Hc.T), jax.jacfwd(j_nlp.cons)(xj),
                jax.hessian(lag)(xj))

    jJ, jH, Jd, Hd = jax_side(jnp.asarray(x), jnp.asarray(lam))
    Jd, Hd = np.asarray(Jd), np.asarray(Hd)
    tJ, tH = structured_derivatives(
        t_nlp, t_maps, torch.as_tensor(x)[None], torch.as_tensor(lam)[None], None
    )
    return dict(
        j_nlp=j_nlp, t_nlp=t_nlp, j_maps=j_maps, t_maps=t_maps, jJ=jJ, jH=jH, tJ=tJ,
        tH=tH, Jd=Jd, Hd=Hd, eq=eq,
    )


def test_block_gathers_match_jax(case9):
    for got, want in zip(tuple(case9["tJ"]) + tuple(case9["tH"]), tuple(case9["jJ"]) + tuple(case9["jH"])):
        assert _rel(got[0].numpy(), want) <= 1e-12


def test_block_matvecs_match_jax_and_dense(case9):
    maps, J, H, Jd, Hd = case9["t_maps"], case9["tJ"], case9["tH"], case9["Jd"], case9["Hd"]
    jm, jJ, jH = case9["j_maps"], case9["jJ"], case9["jH"]
    rng = np.random.default_rng(0)
    n, m = Jd.shape[1], Jd.shape[0]
    v, y = rng.standard_normal(n), rng.standard_normal(m)
    vt, yt = torch.as_tensor(v)[None], torch.as_tensor(y)[None]
    checks = [
        (maps.j_mv(J, vt), Jd @ v, jm.j_mv(jJ, jnp.asarray(v))),
        (maps.j_rmv(J, yt), Jd.T @ y, jm.j_rmv(jJ, jnp.asarray(y))),
        (maps.h_mv(H, vt), Hd @ v, jm.h_mv(jH, jnp.asarray(v))),
        (maps.j_row_norms(J), np.sqrt((Jd * Jd).sum(1)), jm.j_row_norms(jJ)),
    ]
    diag, rowabs = maps.h_diag_rowabs(H)
    jdiag, jrowabs = jm.h_diag_rowabs(jH)
    checks += [(diag, np.diagonal(Hd), jdiag), (rowabs, np.abs(Hd).sum(1), jrowabs)]
    H2 = maps.h_add_diag(H, torch.tensor([3.5], dtype=torch.float64))
    checks.append((maps.h_mv(H2, vt), Hd @ v + 3.5 * v, jm.h_mv(jm.h_add_diag(jH, 3.5), jnp.asarray(v))))
    for got, dense, jax_val in checks:
        assert _rel(got[0].numpy(), dense) <= 1e-12
        assert _rel(got[0].numpy(), jax_val) <= 1e-12
    # layout maps: blocks and back is the identity, padding reads zero
    x_p, x_s = maps.to_blocks(vt)
    assert torch.equal(maps.from_blocks(x_p, x_s), vt)
    assert torch.equal(x_p[0][~maps.int_mask], torch.zeros(int((~maps.int_mask).sum()), dtype=torch.float64))
    assert torch.equal(maps.rows_scatter(maps.rows_gather(yt)), yt)


def _ipm_state(m, n, seed=1):
    """An IPM trip's operator inputs: diagonal terms, folded 1/E, the stiff
    set (equality rows and the rows of smallest E) and its E."""
    rng = np.random.default_rng(seed)
    diag_k = 0.1 + rng.random(n)
    E = np.exp(rng.uniform(-6.0, 2.0, m))
    return diag_k, E


def _jax_op(case9, opts):
    return j_bbd.BbdOperator(case9["j_maps"], case9["jJ"], case9["jH"], opts)


def _torch_op(case9, opts):
    return t_bbd.BbdOperator(case9["t_maps"], case9["tJ"], case9["tH"], opts)


def test_prepare_solve_block_matches_jax_float64(case9):
    nlp = case9["j_nlp"]
    n, m = nlp.n, nlp.m
    diag_k, E = _ipm_state(m, n)
    stiff = (E < 1.0) | case9["eq"]
    invE = np.where(~stiff, 1.0 / E, 0.0)
    E_st = np.where(stiff, E, 1.0)
    rng = np.random.default_rng(2)
    r1, r2 = rng.standard_normal(n), rng.standard_normal(m)
    j_op = _jax_op(case9, j_qp.IpmOptions(ir_steps=2))
    t_op = _torch_op(case9, t_qp.IpmOptions(ir_steps=2))
    j_stiff = j_op.cap_stiff(jnp.asarray(stiff), jnp.asarray(E), 0)
    t_stiff = t_op.cap_stiff(torch.as_tensor(stiff)[None], torch.as_tensor(E)[None], 0)
    np.testing.assert_array_equal(t_stiff[0].numpy(), np.asarray(j_stiff))
    rhs2 = np.where(stiff, r2, 0.0)

    @jax.jit
    def jax_prepare_solve(diag_k, invE, j_stiff, E_st, r1, rhs2):
        j_solve, j_delta = j_op.prepare(diag_k, invE, j_stiff, E_st, 0.0)
        return j_solve(r1, rhs2) + (j_delta,)

    j_dp, j_dy, j_delta = jax_prepare_solve(
        *(jnp.asarray(a) for a in (diag_k, invE, np.asarray(j_stiff), E_st, r1, rhs2))
    )
    t_solve, t_delta = t_op.prepare(
        torch.as_tensor(diag_k)[None], torch.as_tensor(invE)[None], t_stiff,
        torch.as_tensor(E_st)[None], torch.zeros(1, dtype=torch.float64),
    )
    assert float(t_delta[0]) == float(j_delta)
    t_dp, t_dy = t_solve(torch.as_tensor(r1)[None], torch.as_tensor(rhs2)[None])
    assert _rel(t_dp[0].numpy(), j_dp) <= 1e-10
    assert _rel(t_dy[0].numpy(), j_dy) <= 1e-10
    # and it solves the block system: K dp + A_t' dy = r1, A_t dp - E_t dy = r2
    st = np.asarray(j_stiff)
    K = case9["Hd"] + np.diag(diag_k) + case9["Jd"].T @ np.diag(invE) @ case9["Jd"]
    K = K + float(t_delta[0]) * np.diag(np.abs(np.diagonal(K)))  # the ladder's shift
    dp, dy = t_dp[0].numpy(), t_dy[0].numpy()
    res1 = K @ dp + case9["Jd"].T @ dy - r1
    res2 = np.where(st, case9["Jd"] @ dp - E_st * dy - r2, 0.0)
    assert float(np.abs(np.concatenate([res1, res2])).max()) <= 1e-8 * (1 + np.abs(r1).max())


def test_stiff_slots_with_ties_follow_top_k():
    """case118's parts (cap_p = 112 of mr = 208 slots), E drawn from three
    values so that ties straddle the cap: the port's stable sort picks JAX's
    ``lax.top_k`` rows in JAX's slot order, and caps the stiff set as JAX's
    ``cap_stiff`` does."""
    case = t_matpower.load_case("case118")
    nlp = t_acopf.acopf_polar(case)
    gl, gu = np.asarray(nlp.g_l), np.asarray(nlp.g_u)
    eq = np.isfinite(gl) & (gl == gu)
    bs = t_build(nlp.n, nlp.m, nlp.structure, eq)
    maps = t_bbd.BlockMaps(bs)
    j_maps = j_bbd.BlockMaps(j_build(nlp.n, nlp.m, nlp.structure, eq))
    rng = np.random.default_rng(4)
    B = 3
    E = rng.choice([1e-4, 1e-2, 0.5], size=(B, nlp.m))
    E[1, :40] = np.inf  # non-finite E never counts as stiff
    stiff = rng.random((B, nlp.m)) < 0.8
    cpu = torch.device("cpu")
    op = t_bbd.BbdOperator(
        maps, maps.zero_jac(B, torch.float64, cpu), maps.zero_hess(B, torch.float64, cpu),
        t_qp.IpmOptions(),
    )
    assert op.cap_p == 112
    sel, _, _ = op._select(torch.as_tensor(stiff), torch.as_tensor(E))
    capped = op.cap_stiff(torch.as_tensor(stiff), torch.as_tensor(E), 0)
    zJ = (jnp.zeros((bs.P, bs.mr, bs.nd)), jnp.zeros((bs.P, bs.mr, bs.ns)))
    zH = (jnp.zeros((bs.P, bs.nd, bs.nd)), jnp.zeros((bs.P, bs.nd, bs.ns)), jnp.zeros((bs.ns, bs.ns)))
    j_op = j_bbd.BbdOperator(j_maps, zJ, zH, j_qp.IpmOptions())
    for b in range(B):
        st_p = j_maps.rows_gather(jnp.asarray(stiff[b]))
        E_p = j_maps.rows_gather(jnp.asarray(E[b]))
        key = jnp.where(jnp.logical_and(st_p, jnp.isfinite(E_p)), E_p, j_bbd._BIG)
        _, want = lax.top_k(-key, op.cap_p)
        np.testing.assert_array_equal(sel[b].numpy(), np.asarray(want))
        want_mask = j_op.cap_stiff(jnp.asarray(stiff[b]), jnp.asarray(E[b]), 0)
        np.testing.assert_array_equal(capped[b].numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("mixed", [False, True])
def test_structured_qp_matches_jax(case9, mixed):
    """One elastic QP through solve_qp_op with the structured operator."""
    nlp = case9["j_nlp"]
    n, m = nlp.n, nlp.m
    rng = np.random.default_rng(6)
    c = rng.standard_normal(n)
    # rows feasible at a point inside the box: equalities at J p0, the
    # inequalities (thermal limits) with room above it
    Jp0 = case9["Jd"] @ rng.uniform(-0.2, 0.2, n)
    rl = np.where(case9["eq"], Jp0, -np.inf)
    ru = np.where(case9["eq"], Jp0, Jp0 + 0.2 + rng.random(m))
    lb, ub = -np.full(n, 0.5), np.full(n, 0.5)
    w = np.full(m, 1e4)
    kw = dict(factor_dtype="float32", ir_steps=2, tol=2e-6, invE_floor=3e-7) if mixed else dict(
        invE_floor=3e-7, tol=2e-6
    )
    shift = 1.0 - float(np.linalg.eigvalsh(case9["Hd"])[0])  # a convex QP
    H_psd = case9["t_maps"].h_add_diag(case9["tH"], torch.tensor([shift], dtype=torch.float64))
    jH = case9["j_maps"].h_add_diag(case9["jH"], shift)
    j_opts, t_opts = j_qp.IpmOptions(**kw), t_qp.IpmOptions(**kw)
    j_sol = j_qp.solve_qp_op(
        j_bbd.BbdOperator(case9["j_maps"], case9["jJ"], jH, j_opts),
        *(jnp.asarray(a) for a in (c, rl, ru, lb, ub, w)), opts=j_opts,
    )
    t_sol = t_qp.solve_qp_op(
        t_bbd.BbdOperator(case9["t_maps"], case9["tJ"], H_psd, t_opts),
        *(torch.as_tensor(a)[None] for a in (c, rl, ru, lb, ub, w)), opts=t_opts,
    )
    assert bool(j_sol.converged) and bool(t_sol.converged[0])
    assert int(t_sol.iters[0]) == int(j_sol.iters)
    tol = 1e-6 if mixed else 1e-10
    assert _rel(t_sol.p[0].numpy(), j_sol.p) <= tol
    assert _rel(t_sol.y[0].numpy(), j_sol.y) <= tol
