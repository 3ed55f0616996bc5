"""The float32 matrix plane (``kkt_precision="mixed_plane"``) of the port's
``DenseOp`` against the JAX package's.

* Building blocks (``ops/linsolve.py``): ``factorize_spd`` with
  ``min_pivot=1e-3`` on already-equilibrated float32 matrices (the plane's
  ``Ks`` / ``Ss``, ``equilibrate=False``) gives every lane the vmapped JAX
  ladder's ``delta`` (rtol 1e-6: float32 rungs and bisection, the same IEEE
  operations; only the float32 factors behind each accept/reject decision
  are computed by other code) and a factor within 1e-5 of JAX's (float32
  rounding of two Cholesky codes); ``tri_inv`` at n = 12 and n = 130 (two
  128-panels) within 1e-5; ``cho_solve`` is the triangular-solve pair.
* ``DenseOp.prepare`` + ``solve_block`` on seeded QPs (n=12, m=20, batch 4:
  two SPD lanes, one with a warm ``delta0``, and two indefinite lanes whose
  ladder escalates, one from ``delta0=0`` and one from ``delta0=1e-6``),
  uncapped and ``schur_cap=8``, explicit inverse factors or triangular
  solves, JAX on ``"xla"`` and on ``"pallas"`` (interpret mode) and the port
  on its plain kernel route: ``delta`` equal lane for lane (rtol 1e-6),
  ``dp`` / ``dy`` within 1e-11 of JAX's relative to their largest entry
  (both refine the float32 solve three times in float64; the remaining
  difference is float32 rounding contracted three times), and within 1e-11
  of a float64 direct solve of the 2x2 block the plane refines against
  (``K + delta diag(K)``, with K's diagonal as assembled in float32).
* The IPM over the plane (``solve_qp``, capped, float32 factors) on four
  random feasible QPs: iteration counts and convergence equal to the
  vmapped JAX solve's, converged lanes' solutions within 1e-5.
* Under a caller's ``torch.set_float32_matmul_precision("high")`` or
  ``"medium"`` (which on this CPU computes float32 products through bfloat16)
  the plane gives bit for bit the ``"highest"`` result: its products and
  factorizations run with TF32 / reduced precision off, and the caller's
  setting is back after ``prepare`` and ``solve_block``.
* Whole solves against ``data/anchor_plane_single.json`` (``scripts/
  torch_anchor.py --plane --single``; JAX on the CPU): one-lane case30 with
  ``tests/test_schur_cap.py``'s plane parameters (``power`` shift, SOC)
  through ``optimize``, SQP-LS hs071, structured case9 under ``ladder`` and
  case30 b4 at the batched configuration through ``make_batch_solver`` and
  ``make_chunked_batch_solver``.  Status equal and the objective within 1e-6
  relative on every solve; iterations equal where the float32 factors do
  not decide them (hs071).  The case30 solves take the JAX package's
  Lanczos start vector (the port draws its own from numpy), and their
  iteration counts may differ by up to two per lane: on these float32-factor
  paths rounding moves a lane's count, and the JAX package itself moves
  case30 b4 lanes' counts and trips between its ``"xla"`` and ``"pallas"``
  factor routes (the anchor's ``batch_lanes_xla`` beside ``batch_lanes``;
  ROADMAP, differences that are not faults).  Structured
  case9 ignores the plane (``BbdOperator`` has none), so it is bit for bit
  the ``mixed_ir`` run, as in JAX.

No JAX whole solve runs here: on the CPU they cost several times the port's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.ops import linsolve as j_lin
from sqpsolver_tpu.ops import qp_ipm as j_qp
from sqpsolver_tpu_torch.algorithms import common as t_common
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.hs import hs_problem
from sqpsolver_tpu_torch.models.matpower import load_case
from sqpsolver_tpu_torch.models.power import case9
from sqpsolver_tpu_torch.ops import chol_blocked as t_chol
from sqpsolver_tpu_torch.ops import linsolve as t_lin
from sqpsolver_tpu_torch.ops import qp_ipm as t_qp

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqpsolver_tpu_torch", "data")
N, M, B, CAP = 12, 20, 4, 8
VARIANTS = [(cap, inv) for cap in (0, CAP) for inv in (True, False)]
BACKENDS = ("xla", "pallas")


def _anchor(name):
    with open(os.path.join(DATA, name)) as fh:
        return json.load(fh)


def _kkt_batch(seed=0):
    """Arguments of ``prepare`` and ``solve_block`` for B lanes: lanes 0-1
    SPD (delta0 0 and 1e-4), lanes 2-3 indefinite (delta0 0 and 1e-6: the
    ladder escalates from the floor and from delta0).  Each lane has at most
    ``CAP`` stiff rows, as the IPM caps them before ``prepare``."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, N, N))
    Q = G @ G.transpose(0, 2, 1) / N
    Q[2:] -= 1.5 * np.eye(N)
    A = rng.standard_normal((B, M, N)) / np.sqrt(N)
    diag_k = 10.0 ** rng.uniform(-3, 1, (B, N))
    stiff = np.zeros((B, M), bool)
    for b, k in enumerate((6, CAP, 5, 7)):
        stiff[b, rng.choice(M, k, replace=False)] = True
    E = 10.0 ** rng.uniform(-7, -1, (B, M))
    invE_soft = np.where(stiff, 0.0, 10.0 ** rng.uniform(-2, 4, (B, M)))
    E_stiff = np.where(stiff, E, 1.0)
    delta0 = np.array([0.0, 1e-4, 0.0, 1e-6])
    r1 = rng.standard_normal((B, N))
    r2 = np.where(stiff, rng.standard_normal((B, M)), 0.0)
    return Q, A, diag_k, invE_soft, stiff, E_stiff, delta0, r1, r2


def _opts(mod, backend, cap, invert):
    return mod.IpmOptions(factor_dtype="float32", plane=True, ir_steps=2, kkt_backend=backend,
                          invert_factors=invert, schur_cap=cap, invE_floor=3e-7)


@pytest.fixture(scope="module")
def jax_plane():
    """JAX's plane, vmapped over the lanes: every (cap, invert) variant per
    backend in one compiled program."""
    args = [jnp.asarray(a) for a in _kkt_batch()]
    out = {}
    for backend in BACKENDS:

        def lane(Q, A, dk, iE, st, Es, d0, r1, r2, backend=backend):
            res = []
            for cap, inv in VARIANTS:
                op = j_qp.DenseOp(Q, A, _opts(j_qp, backend, cap, inv), jnp.float64)
                solve_block, delta = op.prepare(dk, iE, st, Es, d0)
                res.append((*solve_block(r1, r2), delta))
            return res

        got = jax.jit(jax.vmap(lane))(*args)
        for (cap, inv), r in zip(VARIANTS, got):
            out[backend, cap, inv] = [np.asarray(x) for x in r]
    return out


def _port_plane(backend, cap, invert, args=None):
    T = [torch.as_tensor(a) for a in (args or _kkt_batch())]
    op = t_qp.DenseOp(T[0], T[1], _opts(t_qp, backend, cap, invert), torch.float64)
    solve_block, delta = op.prepare(*T[2:7])
    dp, dy = solve_block(T[7], T[8])
    return dp, dy, delta


def _direct(delta):
    """float64 solve of [K + delta diag(K32), A_t'; A_t, -E_t] (dp; dy) =
    (r1; r2): the system the plane refines against, whose ladder term is
    ``delta`` times the diagonal of K as the plane assembles it in float32."""
    Q, A, dk, iE, st, Es, _, r1, r2 = _kkt_batch()
    Q32, A32, dk32, iE32 = (torch.as_tensor(a, dtype=torch.float32) for a in (Q, A, dk, iE))
    K32 = Q32 + torch.diag_embed(dk32) + torch.matmul(A32.transpose(-1, -2) * iE32[:, None, :], A32)
    diag32 = torch.diagonal(K32, dim1=-2, dim2=-1).abs().double().numpy()
    dps, dys = [], []
    for b in range(B):
        K = Q[b] + np.diag(dk[b]) + (A[b].T * iE[b]) @ A[b] + delta[b] * np.diag(diag32[b])
        At = np.where(st[b][:, None], A[b], 0.0)
        KKT = np.block([[K, At.T], [At, -np.diag(Es[b])]])
        x = np.linalg.solve(KKT, np.concatenate([r1[b], r2[b]]))
        dps.append(x[:N])
        dys.append(x[N:])
    return np.stack(dps), np.stack(dys)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cap,invert", VARIANTS)
def test_dense_plane_matches_jax(jax_plane, backend, cap, invert):
    calls0 = t_chol.cholesky_blocked.calls
    dp, dy, delta = (x.numpy() for x in _port_plane(backend, cap, invert))
    # the kernel route factors K and S (and every ladder try) through the
    # blocked Cholesky, whose tiles are chol_tile's; the library route never
    assert (t_chol.cholesky_blocked.calls > calls0) == (backend == "pallas")
    j_dp, j_dy, j_delta = jax_plane[backend, cap, invert]
    assert delta.dtype == np.float64
    np.testing.assert_allclose(delta, j_delta, rtol=1e-6, atol=0)
    assert delta[0] == 0.0 and delta[1] == np.float32(1e-4) and (delta[2:] > 1e-4).all()
    assert _rel(dp, j_dp) <= 1e-11 and _rel(dy, j_dy) <= 1e-11
    d_dp, d_dy = _direct(delta)
    assert _rel(dp, d_dp) <= 1e-11 and _rel(dy, d_dy) <= 1e-11
    stiff = _kkt_batch()[4]
    assert (dy[~stiff] == 0.0).all()


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_plane_products_run_in_true_float32(precision, monkeypatch):
    want = [x.numpy() for x in _port_plane("pallas", CAP, True)]
    seen = []
    factorize = t_qp.factorize_spd

    def spy(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return factorize(*a, **kw)

    monkeypatch.setattr(t_qp, "factorize_spd", spy)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        T = [torch.as_tensor(a) for a in _kkt_batch()]
        op = t_qp.DenseOp(T[0], T[1], _opts(t_qp, "pallas", CAP, True), torch.float64)
        solve_block, delta = op.prepare(*T[2:7])
        assert torch.get_float32_matmul_precision() == precision
        dp, dy = solve_block(T[7], T[8])
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(before)
    assert seen == ["highest", "highest"]
    for got, ref in zip((dp, dy, delta), want):
        assert np.array_equal(got.numpy(), ref)


def _random_qps(seed, n=10, m=14, batch=4):
    """Feasible elastic QPs shaped like ``tests/test_torch_qp.py``'s: SPD Q,
    box bounds, a mix of two-sided, one-sided and equality rows."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((batch, n, n)) / np.sqrt(n)
    Q = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(n)
    c = rng.standard_normal((batch, n))
    A = rng.standard_normal((batch, m, n)) / np.sqrt(n)
    mid = np.einsum("bmn,bn->bm", A, rng.standard_normal((batch, n)) * 0.1)
    half = np.abs(rng.standard_normal((batch, m))) + 0.1
    kind = rng.integers(0, 4, (batch, m))
    rl = np.where(kind == 1, -np.inf, mid - half)
    ru = np.where(kind == 2, np.inf, mid + half)
    rl = np.where(kind == 3, ru, rl)
    box = np.full((batch, n), 2.0)
    return Q, c, A, rl, ru, -box, box, np.full((batch, m), 1e8)


def test_plane_ipm_takes_jax_iterations():
    """The whole IPM over the plane (capped Schur set, float32 factors):
    per-lane iteration counts and convergence equal to the vmapped JAX
    solve's, the converged lanes' solutions within 1e-5 (the tolerance
    ``test_torch_qp.py`` holds float32-factor solves to)."""
    arrs = _random_qps(4)
    kw = dict(factor_dtype="float32", plane=True, ir_steps=4, invE_floor=3e-7, schur_cap=8,
              tol=2e-6, max_iter=30)
    j_opts, t_opts = j_qp.IpmOptions(**kw), t_qp.IpmOptions(**kw)
    jsol = jax.jit(jax.vmap(lambda *a: j_qp.solve_qp(*a, opts=j_opts)))(
        *(jnp.asarray(a) for a in arrs))
    tsol = t_qp.solve_qp(*(torch.as_tensor(a) for a in arrs), opts=t_opts)
    np.testing.assert_array_equal(tsol.iters.numpy(), np.asarray(jsol.iters))
    conv = tsol.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(jsol.converged))
    assert conv.sum() >= 3  # a lane at the float32 floor stops unconverged on both sides
    for field in ("p", "y"):
        j = np.asarray(getattr(jsol, field))[conv]
        assert _rel(getattr(tsol, field).numpy()[conv], j) <= 1e-5, field


def test_rescue_op_drops_the_plane():
    T = [torch.as_tensor(a) for a in _kkt_batch()]
    op = t_qp.DenseOp(T[0], T[1], _opts(t_qp, "pallas", CAP, True), torch.float64)
    assert op.mixed_plane
    for keep in (True, False):
        twin = op.rescue_op(keep_cap=keep)
        assert not twin.mixed_plane and twin.fdtype == torch.float64
        assert twin.opts.schur_cap == (CAP if keep else 0)


# ------------------------------------------------------- building blocks ---


def _equilibrated_f32(seed=5, n=N):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    Mx = G @ G.transpose(0, 2, 1) / n + 1e-3 * np.eye(n)
    Mx[2] -= 1.2 * np.eye(n)  # indefinite: escalates from the floor
    Mx[3] -= 0.8 * np.eye(n)
    d = 1.0 / np.sqrt(np.abs(np.diagonal(Mx, axis1=1, axis2=2)))
    return (Mx * d[:, :, None] * d[:, None, :]).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_factorize_spd_on_equilibrated_float32_matches_jax(backend):
    Ms = _equilibrated_f32()
    delta0 = np.array([0.0, 1e-3, 0.0, 1e-6], np.float32)
    jf = jax.jit(jax.vmap(
        lambda Mi, d0: j_lin.factorize_spd(Mi, d0, backend=backend, min_pivot=1e-3)
    ))(jnp.asarray(Ms), jnp.asarray(delta0))
    tf = t_lin.factorize_spd(torch.as_tensor(Ms), torch.as_tensor(delta0), backend=backend,
                             min_pivot=1e-3)
    assert tf.chol.dtype == torch.float32 and tf.delta.dtype == torch.float32
    np.testing.assert_allclose(tf.delta.numpy(), np.asarray(jf.delta), rtol=1e-6, atol=0)
    assert (tf.delta.numpy()[2:] > 0).all() and tf.ok.all()
    assert _rel(tf.chol.numpy(), np.asarray(jf.chol)) <= 1e-5


@pytest.mark.parametrize("n", [N, 130])
def test_tri_inv_matches_jax(n):
    Ms = _equilibrated_f32(seed=6, n=n)[:2]
    L = np.linalg.cholesky(Ms.astype(np.float64)).astype(np.float32)
    want = np.asarray(jax.jit(j_lin.tri_inv)(jnp.asarray(L)))
    got = t_lin.tri_inv(torch.as_tensor(L)).numpy()
    assert _rel(got, want) <= 1e-5


def test_cho_solve_is_the_triangular_pair():
    Ms = _equilibrated_f32(seed=7)[:2].astype(np.float64)
    L = torch.as_tensor(np.linalg.cholesky(Ms))
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((2, N, 3)))
    x = t_lin.cho_solve(L, b, vec=False)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(Ms, b.numpy()), rtol=1e-10)
    for j in range(3):
        xv = t_lin.cho_solve(L, b[:, :, j], vec=True)
        np.testing.assert_allclose(xv.numpy(), x[:, :, j].numpy(), rtol=1e-12)
        Li = t_lin.tri_inv(L)
        np.testing.assert_allclose(
            t_lin.inv_chol_solve(Li, b[:, :, j], vec=True).numpy(), xv.numpy(), rtol=1e-9
        )
    x32 = t_lin.cho_solve(L.float(), b, vec=False)
    assert x32.dtype == torch.float32


# ---------------------------------------------------------- whole solves ---


@pytest.fixture
def jax_lanczos_start(monkeypatch):
    """The port's Lanczos bound started from the JAX package's vector."""

    def start(n, dtype, device):
        v0 = jax.random.normal(jax.random.PRNGKey(20240819), (n,), jnp.float64)
        return torch.as_tensor(np.array(v0 / jnp.linalg.norm(v0)), dtype=dtype, device=device)

    monkeypatch.setattr(t_common, "lanczos_start", start)


def _plane_problem(name):
    if name == "case30":
        return acopf_polar(load_case("case30"), scenario_batchable=False)
    if name == "hs071_ls":
        return hs_problem("hs071").nlp
    return acopf_polar(case9(), scenario_batchable=False)


#: the largest per-lane iteration difference to the anchor each solve may
#: show (module docstring)
ITER_SLACK = {"case30": 2, "hs071_ls": 0, "structured_case9": 1}


@pytest.mark.parametrize("name", list(ITER_SLACK))
def test_plane_optimize_matches_jax(name, jax_lanczos_start):
    anchor = _anchor("anchor_plane_single.json")
    want = anchor["solves"][name]
    params = tp.Parameters(**anchor["params"][name])
    assert params.kkt_precision == "mixed_plane"
    res = tp.optimize(_plane_problem(name), params, device="cpu")
    assert int(res.status) == want["status"] == 0
    assert abs(res.obj_val - want["obj"]) <= 1e-6 * abs(want["obj"])
    assert abs(res.iterations - want["iterations"]) <= ITER_SLACK[name]
    if name == "case30":  # tests/test_schur_cap.py's own check
        np.testing.assert_allclose(res.obj_val, 576.977, rtol=1e-3)
    if name == "structured_case9":  # BbdOperator has no plane: mixed_ir bit for bit
        twin = tp.optimize(_plane_problem(name),
                           tp.Parameters(**dict(anchor["params"][name], kkt_precision="mixed_ir")),
                           device="cpu")
        assert np.array_equal(res.x, twin.x) and res.qp_iters_total == twin.qp_iters_total


@pytest.mark.parametrize("entry", ["batch", "chunked"])
def test_plane_case30_b4_matches_jax(entry):
    anchor = _anchor("anchor_plane_single.json")
    cfg, lanes = anchor["batch"], anchor["batch_lanes"]
    case = load_case(cfg["case"])
    nlp = acopf_polar(case)
    theta = load_scenarios(case, cfg["batch"], seed=cfg["seed"], spread=cfg["spread"])
    params = tp.Parameters(**cfg["params"])
    assert (params.kkt_precision, params.kkt_backend) == ("mixed_plane", "pallas")
    if entry == "batch":
        solver = tp.make_batch_solver(nlp, params)
    else:
        solver = tp.make_chunked_batch_solver(nlp, params, sub_batch=2)
    out = tp.result_to_numpy(solver(tp.batch_data(nlp, cfg["batch"], theta=theta, device="cpu")))
    np.testing.assert_array_equal(out["status"], lanes["status"])
    assert np.isin(out["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(out["obj_val"], lanes["obj"], rtol=1e-6)
    assert np.abs(out["iterations"] - np.asarray(lanes["iterations"])).max() <= ITER_SLACK["case30"]
    assert np.isfinite(out["x"]).all() and out["x"].shape == (cfg["batch"], nlp.n)


@pytest.mark.parametrize("name,entry", [("hs071_ls", "batch"), ("structured_case9", "batch"),
                                        ("structured_case9", "chunked")])
def test_plane_batched_entry_points(name, entry):
    """SQP-LS and the structured path under the plane through the batched
    entry points: two copies of the anchored one-lane problem, each lane at
    the anchor's status and objective (the chunked solver is SQP-TR's)."""
    anchor = _anchor("anchor_plane_single.json")
    want = anchor["solves"][name]
    nlp = _plane_problem(name)
    params = tp.Parameters(**anchor["params"][name])
    solver = (tp.make_batch_solver(nlp, params) if entry == "batch"
              else tp.make_chunked_batch_solver(nlp, params, sub_batch=1))
    out = tp.result_to_numpy(solver(tp.batch_data(nlp, 2, device="cpu")))
    assert out["status"].tolist() == [want["status"]] * 2
    np.testing.assert_allclose(out["obj_val"], want["obj"], rtol=1e-6)
    assert np.abs(out["iterations"] - want["iterations"]).max() <= ITER_SLACK[name]
