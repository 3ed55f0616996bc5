"""The port's batched AD bundle (torch.func) against the JAX package's.

f, grad f, the constraint Jacobian and the Lagrangian Hessian of the toy
problem and of ACOPF (polar) on MATPOWER case30, at random points,
multipliers and load scenarios made with numpy, in float64.  Tolerance:
max|port - jax| <= 1e-11 * max(1, max|jax|) per quantity (only summation
order differs between the two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import matpower as j_matpower
from sqpsolver_tpu.models import toy as j_toy
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import toy as t_toy

RTOL = 1e-11
B = 3


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= RTOL, f"{what}: {err:.3e}"


def _jax_bundle(nlp, x, lam, theta):
    def one(xi, li, th):
        f, df = nlp.obj_grad(xi, th)
        return f, df, nlp.cons(xi, th), nlp.cons_jac(xi, th), nlp.lag_hess(xi, li, th)

    th_axes = None if theta is None else 0
    return jax.jit(jax.vmap(one, in_axes=(0, 0, th_axes)))(x, lam, theta)


def _models():
    case_t = t_matpower.load_case("case30")
    case_j = j_matpower.load_case("case30")
    return {
        "toy": (t_toy.toy_nlp(), j_toy.toy_nlp(), None),
        "case30": (t_acopf.acopf_polar(case_t), j_acopf.acopf_polar(case_j), case_t),
    }


@pytest.mark.parametrize("name", ["toy", "case30"])
def test_ad_bundle_matches_jax(name):
    t_nlp, j_nlp, case = _models()[name]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, t_nlp.n)) * 0.3
    if case is not None:  # voltages near 1 p.u.
        x[:, case.nb : 2 * case.nb] += 1.0
    lam = rng.standard_normal((B, t_nlp.m))
    theta = None
    if case is not None:
        theta = t_acopf.load_scenarios(case, B, seed=5, spread=0.2)
    jt = None if theta is None else {k: jnp.asarray(v) for k, v in theta.items()}
    f_j, df_j, g_j, J_j, H_j = _jax_bundle(j_nlp, jnp.asarray(x), jnp.asarray(lam), jt)

    xt = torch.as_tensor(x)
    lt = torch.as_tensor(lam)
    tt = None if theta is None else {k: torch.as_tensor(v) for k, v in theta.items()}
    f_t, df_t = t_nlp.obj_grad(xt, tt)
    f2_t, g_t = t_nlp.obj_cons(xt, tt)
    _close(f_t, f_j, "f")
    _close(f2_t, f_j, "f (obj_cons)")
    _close(df_t, df_j, "grad f")
    _close(g_t, g_j, "g")
    _close(t_nlp.cons_jac(xt, tt), J_j, "J")
    _close(t_nlp.lag_hess(xt, lt, tt), H_j, "hess L")


def test_nlp_data_and_initial_point():
    from sqpsolver_tpu_torch.nlp import NLPData, initial_point

    d = t_toy.toy_nlp().data(dtype=torch.float32, device="cpu")
    assert d.x0.dtype == torch.float32 and d.x0.shape == (2,)
    d = NLPData(
        x_l=torch.tensor([-1.0, 0.0]), x_u=torch.tensor([1.0, 0.5]),
        g_l=d.g_l, g_u=d.g_u, x0=torch.tensor([3.0, -2.0]),
    )
    np.testing.assert_array_equal(initial_point(d).numpy(), [1.0, 0.0])


def test_build_nlp_matches_jax():
    """Row order, bounds and values of build_nlp's assembled g, exactly."""
    from sqpsolver_tpu.nlp import build_nlp as j_build
    from sqpsolver_tpu_torch.nlp import build_nlp as t_build

    def make(lib, build):
        return build(
            lambda x: (x**2).sum(), [0.5, -0.5, 1.0],
            x_l=-2.0, x_u=[2.0, 3.0, 4.0],
            linear=lambda x: x[:1] + 2 * x[1:2], linear_l=-1.0,
            eq=lambda x: x[:1] * x[1:2] - x[2:3],
            ineq=lambda x: lib.stack([x[0] ** 2, x[2] ** 3]), ineq_u=[1.0, 2.0],
        )

    a, b = make(torch, t_build), make(jnp, j_build)
    assert (a.n, a.m, a.num_linear) == (b.n, b.m, b.num_linear)
    for name in ("x_l", "x_u", "g_l", "g_u", "x0"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    x = np.array([0.3, -0.7, 1.1])
    np.testing.assert_allclose(
        a.cons(torch.as_tensor(x)).numpy(), np.asarray(b.cons(jnp.asarray(x))), rtol=1e-15
    )
