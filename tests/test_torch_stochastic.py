"""The port's two-stage coupled model (``models/stochastic.py``) against the
JAX package's, on case9 with K=3 load scenarios sharing the non-slack
dispatch.

* The coupled NLP: ``n``, ``m``, ``num_linear``, bounds, start and the
  block structure (row supports) equal to JAX's.
* f, g and the dense constraint Jacobian at a numpy-seeded point agree with
  JAX's at 1e-12 relative.
* The structured solve (``kkt_structured=True``, ``power`` shift) equals the
  dense one and the JAX package's structured one at 1e-6 relative, both
  solved.  The JAX results come from ``data/anchor_structured_single.json``
  (``scripts/torch_anchor.py --structured --single``): a JAX solve of this
  problem costs more than half a minute on a CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.models import acopf as j_acopf
from sqpsolver_tpu.models import power as j_power
from sqpsolver_tpu.models import stochastic as j_stochastic
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import power as t_power
from sqpsolver_tpu_torch.models import stochastic as t_stochastic

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqpsolver_tpu_torch", "data")


@pytest.fixture(scope="module")
def anchor():
    with open(os.path.join(DATA, "anchor_structured_single.json")) as fh:
        return json.load(fh)


#: the coupled problem: K load scenarios of case9 sharing the non-slack pg
COUPLED = dict(case="case9", K=3, seed=3, spread=0.03)


@pytest.fixture(scope="module")
def coupled():
    cp = COUPLED
    out = {}
    for key, acopf, power, stochastic in (
        ("jax", j_acopf, j_power, j_stochastic), ("torch", t_acopf, t_power, t_stochastic)
    ):
        case = power.case9()
        nlp = acopf.acopf_polar(case)
        thetas = acopf.load_scenarios(case, cp["K"], seed=cp["seed"], spread=cp["spread"])
        out[key] = stochastic.couple_scenarios(nlp, thetas, stochastic.pg_shared_mask(case, nlp))
    return out


def test_coupled_problem_equals_jax(coupled):
    t, j = coupled["torch"], coupled["jax"]
    assert (t.n, t.m, t.num_linear, t.name) == (j.n, j.m, j.num_linear, j.name)
    assert (t.n, t.m, t.num_linear) == (68, 111, 3)
    for field in ("x_l", "x_u", "g_l", "g_u", "x0"):
        np.testing.assert_array_equal(getattr(t, field), np.asarray(getattr(j, field)), err_msg=field)
    for key in ("pd", "qd"):
        np.testing.assert_array_equal(t.theta[key], np.asarray(j.theta[key]))
    assert len(t.structure.row_cols) == len(j.structure.row_cols)
    for i, (a, b) in enumerate(zip(t.structure.row_cols, j.structure.row_cols)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")
    np.testing.assert_array_equal(t.structure.obj_pairs, j.structure.obj_pairs)


def test_coupled_evaluations_match_jax(coupled):
    t, j = coupled["torch"], coupled["jax"]
    rng = np.random.default_rng(12)
    z = np.asarray(j.x0) + 0.05 * rng.standard_normal(j.n)
    th_j = jax.tree.map(jnp.asarray, j.theta)
    zj = jnp.asarray(z)
    want = (float(j.f(zj, th_j)), np.asarray(j.g(zj, th_j)),
            np.asarray(jax.jacfwd(lambda v: j.g(v, th_j))(zj)))
    data = t.data(device="cpu")
    th_t = {k: v[None] for k, v in data.theta.items()}
    zt = torch.as_tensor(z)[None]
    f, g = t.obj_cons(zt, th_t)
    got = (float(f[0]), g[0].numpy(), t.cons_jac(zt, th_t)[0].numpy())
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(b).max())


def test_coupled_structured_solve_matches_dense_and_jax(coupled, anchor):
    assert anchor["coupled"] == COUPLED
    nlp = coupled["torch"]
    dense = tp.optimize(nlp, tp.Parameters(**anchor["params"]["coupled_case9_dense"]), device="cpu")
    struct = tp.optimize(nlp, tp.Parameters(**anchor["params"]["coupled_case9"]), device="cpu")
    want = anchor["solves"]["coupled_case9"]
    assert dense.success and struct.success
    assert int(struct.status) == want["status"]
    assert struct.prim_infeas < 1e-6
    assert abs(struct.obj_val - dense.obj_val) <= 1e-6 * abs(dense.obj_val)
    assert abs(struct.obj_val - want["obj"]) <= 1e-6 * abs(want["obj"])
    assert abs(dense.obj_val - anchor["solves"]["coupled_case9_dense"]["obj"]) <= 1e-6 * abs(want["obj"])
