"""The port's line-search SQP (``algorithm="SQP-LS"``) against the JAX
package's, on the CPU in float64.

* The Armijo search: the port evaluates all ``n_bt`` trial steps of every
  lane in one batched call and takes the first that passes; a step-by-step
  loop that mirrors the JAX package's ``lax.scan`` (``alpha <- tau * alpha``,
  keep the first passing ``alpha``, else 1) picks the same ``alpha`` and the
  same pass/fail flag, bit for bit, on the toy problem, hs071, hs005 (sin),
  hs110 (log, prod) and ACOPF case9 (with load scenarios).
* ``merit_derivative`` equals the JAX function, scalar and vector penalty.
* Live solves through ``optimize``, default parameters: the toy problem and
  hs014 (the FR path) agree in status, iterations, QP trips and SOC count,
  objective within 1e-10 relative, ``x`` within 1e-8.  hs071 agrees in
  status, objective and ``x``; its iteration count does not: after some 40
  iterations its Armijo tests compare merits that differ in the last bits,
  and the two packages' last-bit rounding (the interior-point solves differ
  from their first trip at 1e-16) sends the two line searches different
  ways (ROADMAP Queue 3).  Up to iteration 40 with the LAPACK-free
  ``gershgorin`` shift every count and ``x`` agree.
* A batch of 4 ACOPF case9 load scenarios through the port's batched LS
  against ``jax.vmap`` of the JAX LS solve, stored by
  ``scripts/torch_anchor.py --tests`` in ``data/anchor_tests.json``, lane by
  lane: status, iterations and counters equal, objective within 1e-10
  relative, ``x`` within the solves' own feasibility target 1e-6.
"""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu as jsqp
import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.algorithms import merit as j_merit
from sqpsolver_tpu.models import hs as j_hs
from sqpsolver_tpu.models import toy as j_toy
from sqpsolver_tpu_torch._lanes import dot
from sqpsolver_tpu_torch.algorithms import merit as t_merit
from sqpsolver_tpu_torch.algorithms.common import constraint_violation
from sqpsolver_tpu_torch.algorithms import sqp_ls
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import hs as t_hs
from sqpsolver_tpu_torch.models import power as t_power
from sqpsolver_tpu_torch.models import toy as t_toy
from sqpsolver_tpu_torch.status import status_name

LS = dict(algorithm="SQP-LS", max_iter=300, OutputFlag=0)
COUNTERS = ("iterations", "qp_iters_total", "n_accept", "n_reject", "n_soc_accept", "n_fr_iters")
ANCHOR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "sqpsolver_tpu_torch", "data", "anchor_tests.json")


def _armijo_problem(name):
    if name == "toy":
        return t_toy.toy_nlp(), None
    if name == "case9":
        case = t_power.case9()
        return t_acopf.acopf_polar(case), t_acopf.load_scenarios(case, 4, seed=3, spread=0.05)
    return t_hs.hs_problem(name).nlp, None


@pytest.mark.parametrize("name", ["toy", "hs071", "hs005", "hs110", "case9"])
def test_armijo_search_equals_the_stepwise_scan(name):
    nlp, theta = _armijo_problem(name)
    B = 4
    params = tp.Parameters(algorithm="SQP-LS")
    d = tp.batch_data(nlp, B, theta=theta, device="cpu")
    rng = np.random.default_rng(42)
    x = tp.initial_point(d) + torch.as_tensor(0.01 * rng.standard_normal((B, nlp.n)))
    x = torch.clamp(x, min=d.x_l, max=d.x_u)
    f, df = nlp.obj_grad(x, d.theta)
    _, E = nlp.obj_cons(x, d.theta)
    p = -df / torch.clamp_min(df.abs().amax(-1, keepdim=True), 1.0) * torch.as_tensor(
        rng.uniform(0.01, 3.0, (B, 1))
    )
    mu = torch.as_tensor(rng.uniform(0.1, 20.0, (B, nlp.m)))
    fr = torch.tensor([False, True, False, False])
    phi = sqp_ls.ls_merit(f, E, x, mu, fr, d)
    cv = constraint_violation(E, d.g_l, d.g_u)
    D = t_merit.merit_derivative(torch.where(fr, 0.5, dot(df, p)), mu, cv)
    alphas = sqp_ls.backtracking_alphas(params.tau, params.min_alpha, torch.float64)
    assert alphas.shape == (132,)  # ceil(log(1e-6) / log(0.9)) with the defaults

    def merit_at(al):
        k = al.shape[0]
        x_t = x[None] + al[:, None, None] * p[None]
        th = None if d.theta is None else {
            key: v.repeat((k,) + (1,) * (v.dim() - 1)) for key, v in d.theta.items()
        }
        f_t, E_t = nlp.obj_cons(x_t.reshape(k * B, nlp.n), th)
        return sqp_ls.ls_merit(f_t.reshape(k, B), E_t.reshape(k, B, nlp.m), x_t, mu, fr, d)

    ls_ok, alpha = sqp_ls.armijo_search(merit_at, phi, D, alphas, params.eta)

    # the JAX scan, one trial step at a time
    step = torch.tensor(1.0, dtype=torch.float64)
    accepted = torch.zeros(B, dtype=torch.bool)
    best = torch.ones(B, dtype=torch.float64)
    for k in range(alphas.shape[0]):
        assert step.item() == alphas[k].item()
        x_t = x + step * p
        f_t, E_t = nlp.obj_cons(x_t, d.theta)
        ok = sqp_ls.ls_merit(f_t, E_t, x_t, mu, fr, d) <= phi + params.eta * step * D
        best = torch.where(ok & ~accepted, step, best)
        accepted = accepted | ok
        step = step * params.tau
    assert torch.equal(ls_ok, accepted)
    assert torch.equal(alpha, best), (alpha, best)
    assert alpha.dtype == torch.float64


def test_merit_derivative_matches_jax():
    rng = np.random.default_rng(5)
    dfp = rng.standard_normal(3)
    viol = np.abs(rng.standard_normal((3, 4)))
    mu_vec = np.abs(rng.standard_normal((3, 4)))
    for mu in (2.5, mu_vec):
        want = [float(j_merit.merit_derivative(jnp.asarray(dfp[i]), jnp.asarray(
            mu if np.isscalar(mu) else mu[i]), jnp.asarray(viol[i]))) for i in range(3)]
        got = t_merit.merit_derivative(
            torch.as_tensor(dfp), mu if np.isscalar(mu) else torch.as_tensor(mu), torch.as_tensor(viol)
        )
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    per_lane = t_merit.merit_derivative(torch.as_tensor(dfp), torch.tensor([1.0, 2.0, 3.0]),
                                        torch.as_tensor(viol))
    np.testing.assert_allclose(per_lane.numpy(), dfp - np.array([1.0, 2.0, 3.0]) * viol.sum(-1))


def _same(tr, jr, what, counters=COUNTERS, x_tol=1e-8):
    assert tr.status == jr.status, f"{what}: {tr.status_name} vs {jr.status_name}"
    for key in counters:
        assert getattr(tr, key) == getattr(jr, key), f"{what}: {key} {getattr(tr, key)} vs {getattr(jr, key)}"
    scale = max(1.0, float(np.abs(jr.x).max()))
    assert float(np.abs(tr.x - jr.x).max()) <= x_tol * scale, f"{what}: x"
    assert abs(tr.obj_val - jr.obj_val) <= 1e-10 * max(1.0, abs(jr.obj_val)), f"{what}: obj"


@pytest.mark.parametrize("name", ["toy", "hs014"])
def test_ls_optimize_matches_jax(name):
    t_nlp = t_toy.toy_nlp() if name == "toy" else t_hs.hs_problem(name).nlp
    j_nlp = j_toy.toy_nlp() if name == "toy" else j_hs.hs_problem(name).nlp
    jr = jsqp.optimize(j_nlp, jsqp.Parameters(**LS))
    tr = tp.optimize(t_nlp, tp.Parameters(**LS), device="cpu")
    _same(tr, jr, name)
    assert tr.success
    assert tr.n_accept == tr.n_reject == tr.n_fr_iters == 0
    if name == "hs014":  # the FR path: infeasible linearizations on the way
        np.testing.assert_allclose(tr.obj_val, t_hs.hs_problem(name).f_star, rtol=1e-3)


def test_ls_hs071_matches_jax():
    t_nlp, j_nlp = t_hs.hs_problem("hs071").nlp, j_hs.hs_problem("hs071").nlp
    jr = jsqp.optimize(j_nlp, jsqp.Parameters(**LS))
    tr = tp.optimize(t_nlp, tp.Parameters(**LS), device="cpu")
    # the round-off-driven tail (module docstring): no count is compared
    _same(tr, jr, "hs071", counters=())
    np.testing.assert_allclose(tr.obj_val, 17.0140173, rtol=1e-6)
    head = dict(LS, max_iter=40, hessian_shift="gershgorin")
    _same(tp.optimize(t_nlp, tp.Parameters(**head), device="cpu"),
          jsqp.optimize(j_nlp, jsqp.Parameters(**head)), "hs071 to iteration 40")


def test_ls_batch_of_case9_matches_jax():
    with open(ANCHOR) as fh:
        anchor = json.load(fh)["ls_case9_b4"]
    kw = anchor["params"]
    assert kw["algorithm"] == "SQP-LS"
    t_case = t_power.case9()
    t_nlp = t_acopf.acopf_polar(t_case)
    theta = t_acopf.load_scenarios(t_case, anchor["batch"], seed=anchor["seed"],
                                   spread=anchor["spread"])
    t_out = tp.make_batch_solver(t_nlp, tp.Parameters(**kw))(
        tp.batch_data(t_nlp, anchor["batch"], theta=theta, device="cpu")
    )
    for lane in range(anchor["batch"]):
        rec = anchor["lanes"][lane]
        jr = SimpleNamespace(**{k: rec[k] for k in COUNTERS + ("status", "success")},
                             status_name=status_name(rec["status"]), x=np.asarray(rec["x"]),
                             obj_val=rec["obj"])
        # x to the solves' own feasibility target: they stop at tol_infeas
        # 1e-6, and the last steps of lane 3 differ by 1.4e-7 with rounding
        _same(tp.from_raw(t_out, 0.0, lane=lane), jr, f"lane {lane}", x_tol=1e-6)
        assert jr.success


def test_ls_hs047_gershgorin_matches_jax():
    """hs047 under the LAPACK-free ``gershgorin`` shift: its first subproblem
    is an equality-constrained QP on a Hessian of condition ~5e9, where the
    Schur complement is symmetric only to rounding.  Before the port's
    library Cholesky symmetrized its input as JAX's does, this QP stalled in
    the port (status 6 after one iteration) and JAX solved hs047 in 23."""
    kw = dict(LS, max_iter=500, hessian_shift="gershgorin")
    jr = jsqp.optimize(j_hs.hs_problem("hs047").nlp, jsqp.Parameters(**kw))
    tr = tp.optimize(t_hs.hs_problem("hs047").nlp, tp.Parameters(**kw), device="cpu")
    _same(tr, jr, "hs047")
    assert tr.success and tr.iterations == 23
