"""The Hock-Schittkowski battery in the port against the JAX package.

* Functions, for every problem of ``models/hs.py`` and the two pathological
  problems: the port's f, g, gradient, constraint Jacobian and Lagrangian
  Hessian against the JAX package's, at the book start ``x0`` and at a point
  drawn with numpy's ``default_rng`` (multipliers drawn likewise); tolerance
  1e-12 relative to the largest entry of each quantity.  Bounds,
  ``num_linear``, ``f_star`` and ``x_star`` equal exactly.
* Whole batteries: every problem through the port's ``optimize`` on the CPU,
  under SQP-TR with the JAX TR battery's parameters and under SQP-LS with
  the JAX LS battery's, held to the JAX package's result on the same problem
  (``sqpsolver_tpu_torch/data/anchor_hs.json``, written by
  ``scripts/torch_anchor.py --hs``): the same status on every problem, and
  the objective within 1e-6 relative where JAX succeeded.  Then the JAX
  batteries' own book targets (``tests/test_hs.py``, ``tests/test_ls.py``),
  with their ledgers mirrored: ``LOCAL_OPTIMA``, ``LOOSE_RTOL`` and the
  known-hard problems ``XFAIL`` / ``XFAIL_LS``, marked ``xfail(strict=False)``
  with their reasons for the book target only (a miss of the JAX anchor
  fails on every problem but one).
* The one: hs106 under SQP-TR (also on the JAX ledger, "crawls") is chaotic
  at the book start.  JAX reaches the iteration cap; the port stops at
  iteration 39 (Infeasible_Problem_Detected).  Their QPs agree to 1e-13
  until iteration 11, whose QP takes 7 or 8 interior-point trips in EITHER
  package when its gradient is perturbed by 1e-13 relative; from starts
  perturbed by 1e-12 the port reaches the cap as JAX does, five times in
  five.  Its anchor status is marked ``xfail(strict=False)`` (``CHAOTIC``,
  ROADMAP Queue 3).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.models import hs as j_hs
from sqpsolver_tpu_torch.models import hs as t_hs
from sqpsolver_tpu_torch.models.toy import toy_nlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_FN = 1e-12
OBJ_RTOL = 1e-6
NAMES = t_hs.hs_names()
PATHOLOGICAL = {"infeasible": "infeasible_nlp", "unbounded": "unbounded_nlp"}

#: the JAX batteries' ledgers (tests/test_hs.py, tests/test_ls.py), mirrored
LOCAL_OPTIMA = {
    "hs002": [0.0504261879, 4.941229318],
    "hs016": [0.25, 23.14466],
    "hs020": [81.5 - 25.0 * np.sqrt(3.0), 83.5 - 25.0 * np.sqrt(3.0)],
}
LOOSE_RTOL = {"hs013": 1e-3}
XFAIL = {
    "hs061": (
        "from the book start (0,0,0) the two equality linearizations wedge "
        "feasibility restoration at a local infeasibility minimum (viol "
        "1.25); scipy SLSQP fails the same way from this start"
    ),
    "hs081": (
        "slow tail convergence: feasible to 1e-8 with objective 0.8% above "
        "f* after 500 iterations and still inching"
    ),
    "hs106": (
        "heat-exchanger design with variables spanning 1e1..1e4 and no "
        "problem scaling in the reference algorithm; crawls"
    ),
}
XFAIL_LS = {
    "hs015": (
        "the LS spec has no trust region: from the book start the Armijo "
        "search walks to a feasible stationary point of the penalty far "
        "above f*; SQP-TR's box escapes it"
    ),
    "hs039": (
        "diverges: the merit line search follows an unbounded descent "
        "direction of the l1 penalty; the trust region keeps TR-SQP bounded"
    ),
    "hs055": (
        "stops at the degenerate vertex f=20/3 from the book start; the TR "
        "battery reaches f*=19/3"
    ),
    "hs061": "same as the TR battery's hs061: restoration wedged at a local infeasibility minimum",
    "hs066": (
        "three consecutive stalled restoration QPs from an infeasible "
        "linearization (status -3); the TR driver's halved box regularizes these"
    ),
    "hs081": "same flat-manifold slow tail as the TR battery's hs081",
}
BATTERY = {
    "SQP-TR": dict(max_iter=500, OutputFlag=0),
    "SQP-LS": dict(algorithm="SQP-LS", max_iter=500, OutputFlag=0),
}
LEDGER = {"SQP-TR": XFAIL, "SQP-LS": XFAIL_LS}
#: problems whose end status is chaotic at the book start (module docstring)
CHAOTIC = {
    "SQP-TR": {
        "hs106": (
            "chaotic at the book start: iteration 11's QP takes 7 or 8 trips in "
            "either package under a 1e-13 perturbation; the port stops at "
            "iteration 39 where JAX reaches the cap, and reaches the cap too "
            "from starts perturbed by 1e-12"
        ),
    },
    "SQP-LS": {},
}


@functools.lru_cache(maxsize=None)
def anchor() -> dict:
    with open(os.path.join(REPO, "sqpsolver_tpu_torch", "data", "anchor_hs.json")) as fh:
        return json.load(fh)


class MissesBookTarget(AssertionError):
    """The solve matches the JAX anchor but misses the book's target."""


class ChaoticStatus(AssertionError):
    """A ``CHAOTIC`` problem ends in another status than the JAX anchor's."""


def _pair(name):
    if name in PATHOLOGICAL:
        return getattr(t_hs, PATHOLOGICAL[name])(), getattr(j_hs, PATHOLOGICAL[name])()
    return t_hs.hs_problem(name).nlp, j_hs.hs_problem(name).nlp


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= RTOL_FN, f"{what}: {err:.3e}"


@pytest.mark.parametrize("name", NAMES + sorted(PATHOLOGICAL))
def test_hs_functions_match_jax(name):
    t_nlp, j_nlp = _pair(name)
    for field in ("n", "m", "num_linear", "maximize"):
        assert getattr(t_nlp, field) == getattr(j_nlp, field), field
    for field in ("x_l", "x_u", "g_l", "g_u", "x0"):
        np.testing.assert_array_equal(getattr(t_nlp, field), getattr(j_nlp, field), err_msg=field)
    if name in PATHOLOGICAL:
        assert t_nlp.name == j_nlp.name
    else:
        t_prob, j_prob = t_hs.hs_problem(name), j_hs.hs_problem(name)
        assert t_prob.f_star == j_prob.f_star
        if j_prob.x_star is None:
            assert t_prob.x_star is None
        else:
            np.testing.assert_array_equal(t_prob.x_star, j_prob.x_star)

    rng = np.random.default_rng(sum(map(ord, name)))
    x0 = np.asarray(j_nlp.x0, float)
    drawn = x0 + 0.05 * (1.0 + np.abs(x0)) * rng.standard_normal(j_nlp.n)
    x = np.stack([x0, np.clip(drawn, j_nlp.x_l, j_nlp.x_u)])
    lam = rng.standard_normal((2, j_nlp.m))

    def one(xi, li):
        f, df = j_nlp.obj_grad(xi, None)
        return f, df, j_nlp.cons(xi, None), j_nlp.cons_jac(xi, None), j_nlp.lag_hess(xi, li, None)

    f_j, df_j, g_j, J_j, H_j = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(lam))
    xt, lt = torch.as_tensor(x), torch.as_tensor(lam)
    f_t, df_t = t_nlp.obj_grad(xt)
    _, g_t = t_nlp.obj_cons(xt)
    _close(f_t, f_j, "f")
    _close(df_t, df_j, "grad f")
    _close(g_t, g_j, "g")
    _close(t_nlp.cons_jac(xt), J_j, "J")
    _close(t_nlp.lag_hess(xt, lt), H_j, "hess L")


def _battery_cases(algorithm):
    cases = []
    for name in NAMES + ["toy"] + sorted(PATHOLOGICAL):
        marks = ()
        if name in CHAOTIC[algorithm]:
            marks = pytest.mark.xfail(
                reason=CHAOTIC[algorithm][name], raises=(ChaoticStatus, MissesBookTarget),
                strict=False,
            )
        elif name in LEDGER[algorithm]:
            marks = pytest.mark.xfail(
                reason=LEDGER[algorithm][name], raises=MissesBookTarget, strict=False
            )
        cases.append(pytest.param(algorithm, name, marks=marks, id=f"{algorithm}-{name}"))
    return cases


@pytest.mark.parametrize("algorithm,name", _battery_cases("SQP-TR") + _battery_cases("SQP-LS"))
def test_battery_matches_jax_anchor(algorithm, name):
    want = anchor()[algorithm][name]
    assert anchor()["params"][algorithm] == BATTERY[algorithm]
    nlp = toy_nlp() if name == "toy" else _pair(name)[0]
    res = tp.optimize(nlp, tp.Parameters(**BATTERY[algorithm]), device="cpu")
    if int(res.status) != want["status"]:
        raise (ChaoticStatus if name in CHAOTIC[algorithm] else AssertionError)(
            f"{name}: {res.status_name} in {res.iterations} vs JAX "
            f"{tp.status_name(want['status'])} in {want['iterations']}"
        )
    if tp.is_success(want["status"]):
        rel = abs(res.obj_val - want["obj"]) / max(1.0, abs(want["obj"]))
        assert rel <= OBJ_RTOL, f"{name}: obj {res.obj_val!r} vs JAX {want['obj']!r}"
    if name in ("toy",) + tuple(PATHOLOGICAL):
        return
    # the JAX batteries' own book targets
    prob = t_hs.hs_problem(name)
    targets = LOCAL_OPTIMA.get(name, [prob.f_star])
    rtol = LOOSE_RTOL.get(name, 1e-4)
    if not res.success or res.prim_infeas > 1e-6:
        raise MissesBookTarget(f"{name}: {res.status_name}, viol {res.prim_infeas:.2e}")
    if not any(np.isclose(res.obj_val, t, rtol=rtol, atol=1e-6) for t in targets):
        raise MissesBookTarget(f"{name}: obj {res.obj_val} not near any of {targets}")
    if algorithm == "SQP-TR" and prob.x_star is not None and name not in LOCAL_OPTIMA:
        if not np.allclose(res.x, prob.x_star, rtol=1e-3, atol=1e-4):
            raise MissesBookTarget(f"{name}: x {res.x} vs {prob.x_star}")
