"""Structured (BBD) SQP-TR in the port against the JAX package.

* Structured case9 through ``optimize``: under the defaults (float64 direct
  factors; the ``eigh`` shift goes to the Lanczos bound, as in JAX) status,
  iterations and QP trips equal to JAX's and the objective within 1e-8
  relative; under ``mixed_ir`` + ``ladder`` (float32 factors) status equal
  and the objective within 1e-6.  With two refinement sweeps (the default)
  the JAX run's fifth iterate sits at a primal infeasibility of 1.5e-6
  against the 1e-6 tolerance, where float32 rounding decides, and the port's
  at 7.7e-7: the iteration counts may differ by one there.  With three
  sweeps neither run is near that edge, and iterations and QP trips are
  equal.
* A 4-lane batched structured case30 solve (``make_batch_solver``) and the
  same through ``make_chunked_batch_solver`` with its rescue fallback, per
  lane against JAX (``kkt_backend="xla"``) at 1e-6: statuses equal and
  solved.
* ``kkt_structured=True`` on an NLP without a structure raises ValueError.
* The dense path after the ``solve_qp_op`` split: ``solve_qp`` and
  ``solve_qp_op`` with a ``DenseOp`` agree bit for bit, and every row is
  allowed into the Schur set.

The JAX results come from ``data/anchor_structured_single.json`` and
``data/anchor_structured_case30_b4.json`` (``scripts/torch_anchor.py
--structured``): on a CPU the JAX solves cost several times the port's.
"""

import json
import os

import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.matpower import load_case
from sqpsolver_tpu_torch.models.power import case9
from sqpsolver_tpu_torch.models.toy import toy_nlp
from sqpsolver_tpu_torch.ops.qp_ipm import DenseOp, IpmOptions, solve_qp, solve_qp_op

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqpsolver_tpu_torch", "data")


def _anchor(name):
    with open(os.path.join(DATA, name)) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["case9", "case9_mixed", "case9_mixed_ir3"])
def test_structured_case9_optimize_matches_jax(name):
    anchor = _anchor("anchor_structured_single.json")
    want = anchor["solves"][name]
    params = tp.Parameters(**anchor["params"][name])
    res = tp.optimize(acopf_polar(case9(), scenario_batchable=False), params, device="cpu")
    assert int(res.status) == want["status"] == 0
    mixed = params.kkt_precision != "direct"
    assert abs(res.obj_val - want["obj"]) <= (1e-6 if mixed else 1e-8) * abs(want["obj"])
    if name == "case9_mixed":
        assert abs(res.iterations - want["iterations"]) <= 1
    else:
        assert (res.iterations, res.qp_iters_total) == (want["iterations"], want["qp_iters_total"])


@pytest.fixture(scope="module")
def case30_b4():
    anchor = _anchor("anchor_structured_case30_b4.json")
    case = load_case(anchor["case"])
    nlp = acopf_polar(case)
    theta = load_scenarios(case, anchor["batch"], seed=anchor["seed"], spread=anchor["spread"])
    # the reference ran the library factors; so does the port in this test
    params = tp.Parameters(**dict(anchor["params"], kkt_backend=anchor["reference"]["kkt_backend"]))
    data = tp.batch_data(nlp, anchor["batch"], theta=theta, device="cpu")
    return anchor, nlp, params, data


@pytest.mark.parametrize("driver", ["batch", "chunked"])
def test_structured_case30_b4_matches_jax(case30_b4, driver):
    anchor, nlp, params, data = case30_b4
    if driver == "batch":
        solver = tp.make_batch_solver(nlp, params)
    else:
        solver = tp.make_chunked_batch_solver(nlp, params, sub_batch=2, rescue_fallback=True)
    out = tp.result_to_numpy(solver(data))
    lanes = anchor["lanes"]
    np.testing.assert_array_equal(out["status"], lanes["status"])
    assert np.isin(out["status"], [0, 1, 6]).all()
    np.testing.assert_allclose(out["obj_val"], lanes["obj"], rtol=1e-6)
    assert np.isfinite(out["x"]).all() and out["x"].shape == (anchor["batch"], nlp.n)


def test_structured_without_structure_raises():
    with pytest.raises(ValueError, match="structure"):
        tp.make_solver(toy_nlp(), tp.Parameters(kkt_structured=True, OutputFlag=0))


def test_dense_solve_qp_is_solve_qp_op_with_a_dense_operator():
    rng = np.random.default_rng(21)
    B, n, m = 3, 9, 6
    G = rng.standard_normal((B, n, n))
    Q = torch.as_tensor(G @ G.transpose(0, 2, 1) + np.eye(n))
    A = torch.as_tensor(rng.standard_normal((B, m, n)))
    c = torch.as_tensor(rng.standard_normal((B, n)))
    rl = torch.as_tensor(np.where(np.arange(m) < 2, 0.1, -np.inf) * np.ones((B, m)))
    ru = torch.as_tensor(np.where(np.arange(m) < 2, 0.1, 1.0) * np.ones((B, m)))
    lb, ub = -torch.ones(B, n, dtype=torch.float64), torch.ones(B, n, dtype=torch.float64)
    w = torch.full((B, m), 1e3, dtype=torch.float64)
    for opts in (IpmOptions(), IpmOptions(factor_dtype="float32", ir_steps=2, schur_cap=4,
                                          invE_floor=3e-7, tol=2e-6)):
        op = DenseOp(Q, A, opts, torch.float64)
        assert op.stiff_allowed().all() and op.stiff_allowed().shape == (m,)
        one = solve_qp(Q, c, A, rl, ru, lb, ub, w, opts=opts)
        two = solve_qp_op(op, c, rl, ru, lb, ub, w, opts=opts)
        for a, b in zip(one, two):
            assert torch.equal(a, b)
        assert one.converged.all()
