"""Whole solves: the port's batched SQP-TR against the JAX package's
``make_batch_solver`` with the same ``Parameters`` on the same data.

* toy problem (with the initial linear-feasibility projection and without;
  the ``eigh``, ``gershgorin`` and ``power`` Hessian shifts): status, x (rel 1e-9) and iteration counts equal; the projection
  run also lands on the golden x* = (-1, -1).
* the Maratos problem with and without the second-order correction: the
  same counters (rejects, SOC accepts) as JAX;
* a locally infeasible problem: the same feasibility-restoration trajectory.
* the slice configuration -- ACOPF polar, dense SQP-TR, ``mixed_ir`` float32
  factors through ``kkt_backend="pallas"`` (the hand-written kernel's path in
  the port; interpret-mode Pallas on the JAX side), ``ladder`` shift, Schur
  cap, rescue and projection off -- on MATPOWER case5 with 4 load
  scenarios (the JAX lanes stored by ``scripts/torch_anchor.py --tests`` in
  ``data/anchor_tests.json``): per-lane status equal and objective within
  1e-7 relative.
  (The full case30 b32 slice runs on the GPU in ``chip_smoke.py`` against
  the stored JAX anchor.)
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.models import toy as j_toy
from sqpsolver_tpu.parallel import batch as j_batch
from sqpsolver_tpu.parameters import Parameters as JParameters
from sqpsolver_tpu_torch.models import acopf as t_acopf
from sqpsolver_tpu_torch.models import matpower as t_matpower
from sqpsolver_tpu_torch.models import toy as t_toy

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqpsolver_tpu_torch", "data")


@pytest.mark.parametrize(
    "projection,shift",
    [("auto", "eigh"), ("off", "eigh"), ("auto", "gershgorin"), ("auto", "power")],
)
def test_toy_matches_jax(projection, shift):
    kw = dict(max_iter=200, OutputFlag=0, init_projection=projection, hessian_shift=shift)
    j_nlp = j_toy.toy_nlp()
    jr = j_batch.make_batch_solver(j_nlp, JParameters(**kw))(j_batch.batch_data(j_nlp, 2))
    t_nlp = t_toy.toy_nlp()
    tr = tp.make_batch_solver(t_nlp, tp.Parameters(**kw))(tp.batch_data(t_nlp, 2, device="cpu"))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-9)
    assert (tr.status.numpy() == 0).all()
    if projection == "auto":
        np.testing.assert_allclose(tr.x.numpy(), -1.0, rtol=1e-4)


def test_solve_restores_float32_matmul_precision():
    """A solve gives the caller's float32 matmul precision back."""
    t_nlp = t_toy.toy_nlp()
    solver = tp.make_batch_solver(t_nlp, tp.Parameters(max_iter=200, OutputFlag=0))
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tr = solver(tp.batch_data(t_nlp, 2, device="cpu"))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    assert (tr.status.numpy() == 0).all()


@pytest.mark.parametrize("use_soc", [True, False])
def test_soc_maratos_matches_jax(use_soc):
    """The second-order correction on the Maratos problem (min 2(x1^2+x2^2-1)
    - x1 s.t. x1^2+x2^2 = 1, x* = (1, 0)), two start points on the circle:
    status, iterations, rejects and SOC accepts equal to JAX, x rel 1e-9;
    with SOC at least one step is rescued."""
    from sqpsolver_tpu.nlp import build_nlp as j_build
    from sqpsolver_tpu_torch.nlp import build_nlp as t_build

    def maratos(build, lib):
        return build(
            lambda x: 2.0 * (x[0] ** 2 + x[1] ** 2 - 1.0) - x[0],
            np.array([np.cos(0.3), np.sin(0.3)]),
            eq=lambda x: lib.stack([x[0] ** 2 + x[1] ** 2 - 1.0]),
        )

    x0 = np.array([[np.cos(t), np.sin(t)] for t in (0.3, 0.8)])
    kw = dict(max_iter=100, OutputFlag=0, use_soc=use_soc)
    j_nlp = maratos(j_build, jnp)
    jr = j_batch.make_batch_solver(j_nlp, JParameters(**kw))(
        j_batch.batch_data(j_nlp, 2, x0=x0)
    )
    t_nlp = maratos(t_build, torch)
    tr = tp.make_batch_solver(t_nlp, tp.Parameters(**kw))(tp.batch_data(t_nlp, 2, x0=x0, device="cpu"))
    for field in ("status", "iterations", "n_reject", "n_soc_accept", "n_accept"):
        np.testing.assert_array_equal(
            getattr(tr, field).numpy(), np.asarray(getattr(jr, field)), err_msg=field
        )
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tr.x.numpy(), [[1.0, 0.0]] * 2, atol=1e-6)
    assert (tr.n_soc_accept.numpy() >= 1).all() == use_soc


def test_feasibility_restoration_matches_jax():
    """A locally infeasible problem (x1^2 + x2^2 = 1, 4 x1 x2 >= 3, x1 >= 0.2)
    from three starts, direct float64 factors: every lane enters restoration;
    statuses, iterations, FR entries, rejects and IPM trips equal to JAX,
    x rel 1e-9."""
    from sqpsolver_tpu.nlp import build_nlp as j_build
    from sqpsolver_tpu_torch.nlp import build_nlp as t_build

    def infeasible(build, lib):
        return build(
            lambda x: (x[0] - 1.0) ** 2 + x[1] ** 2,
            np.array([0.5, 0.5]),
            eq=lambda x: lib.stack([x[0] ** 2 + x[1] ** 2 - 1.0]),
            ineq=lambda x: lib.stack([3.0 - 4.0 * x[0] * x[1], x[0] - 0.2]),
        )

    x0 = np.array([[0.5, 0.5], [2.0, -1.0], [0.1, 0.9]])
    kw = dict(max_iter=40, OutputFlag=0)
    j_nlp = infeasible(j_build, jnp)
    jr = j_batch.make_batch_solver(j_nlp, JParameters(**kw))(
        j_batch.batch_data(j_nlp, 3, x0=x0)
    )
    t_nlp = infeasible(t_build, torch)
    tr = tp.make_batch_solver(t_nlp, tp.Parameters(**kw))(tp.batch_data(t_nlp, 3, x0=x0, device="cpu"))
    for field in ("status", "iterations", "n_fr_iters", "n_reject", "qp_iters_total"):
        np.testing.assert_array_equal(
            getattr(tr, field).numpy(), np.asarray(getattr(jr, field)), err_msg=field
        )
    assert (tr.n_fr_iters.numpy() >= 1).all()
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-9)


@pytest.fixture(scope="module")
def slice_case5():
    with open(os.path.join(DATA, "anchor_tests.json")) as fh:
        anchor = json.load(fh)["slice_case5_b4"]
    params = anchor["params"]
    with open(os.path.join(DATA, "anchor_case30_b32.json")) as fh:
        assert params == json.load(fh)["params"]  # the chip slice's parameters
    t_case = t_matpower.load_case("case5")
    theta = t_acopf.load_scenarios(t_case, anchor["batch"], seed=anchor["seed"],
                                   spread=anchor["spread"])
    t_nlp = t_acopf.acopf_polar(t_case)
    tr = tp.make_batch_solver(t_nlp, tp.Parameters(**params))(
        tp.batch_data(t_nlp, anchor["batch"], theta=theta, device="cpu")
    )
    assert params["kkt_backend"] == "pallas" and params["kkt_precision"] == "mixed_ir"
    lanes = anchor["lanes"]
    j = {key: np.asarray(lanes[field]) for key, field in (
        ("status", "status"), ("obj_val", "obj"), ("iterations", "iterations"),
        ("qp_iters_total", "qp_trips"))}
    return j, tp.result_to_numpy(tr)


def test_slice_status_and_objective(slice_case5):
    j, t = slice_case5
    np.testing.assert_array_equal(t["status"], j["status"])
    assert np.isin(t["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(t["obj_val"], j["obj_val"], rtol=1e-7)


def test_slice_iterations_and_feasibility(slice_case5):
    """SQP iterations equal lane by lane; the final iterates satisfy the
    1e-6 feasibility target (float32 factor rounding may move an IPM trip,
    so trip counts are only required to stay within 5%)."""
    j, t = slice_case5
    np.testing.assert_array_equal(t["iterations"], j["iterations"])
    assert (t["prim_infeas"] <= 1e-6).all()
    assert abs(int(t["qp_iters_total"].sum()) - int(j["qp_iters_total"].sum())) <= 0.05 * int(
        j["qp_iters_total"].sum()
    )
