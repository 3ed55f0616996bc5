"""The port's presolve warm start and checkpointed solve, mirroring the JAX
package's ``tests/test_warmstart.py`` and ``tests/test_checkpoint.py``.

* ``solve_with_checkpoints`` in chunks equals the monolithic solve bit for
  bit (one lane and a batch of three); it resumes from its ``torch.save``
  file (written through a temporary file and a rename); ``time_limit``
  turns unfinished lanes into ``Maximum_CpuTime_Exceeded`` (-4).
* A dual warm start (``lam0``, and ``x0`` at the cold solution) costs no
  extra iteration.
* ``presolve_start`` on ACOPF case9: the warm strict solve reaches the cold
  solve's optimum (and the JAX package's, ``anchor_hs.json``) in fewer SQP
  iterations; the batched form warm-starts a batched solve;
  ``presolve_parameters`` is loose.

Left out: the JAX file's ``test_adaptive_chunked_batch_matches_monolithic``,
whose wall-clock chunk controller the port does not have (ROADMAP, "Do not
port"; the port's chunked batch solver is tested in ``test_torch_chunked.py``).
"""

import json
import os

import numpy as np
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.hs import hs_problem
from sqpsolver_tpu_torch.models.power import case9
from sqpsolver_tpu_torch.models.toy import toy_nlp
from sqpsolver_tpu_torch.utils.checkpoint import solve_with_checkpoints
from sqpsolver_tpu_torch.utils.warmstart import presolve_parameters, presolve_start

PARAMS = tp.Parameters(max_iter=200, OutputFlag=0)
ACOPF = tp.Parameters(max_iter=60, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chunked_matches_monolithic():
    nlp = hs_problem("hs071").nlp
    data = tp.batch_data(nlp, 1, device="cpu")
    direct = tp.make_solver(nlp, PARAMS)(data)
    chunked = solve_with_checkpoints(nlp, PARAMS, data, chunk_iters=7)
    assert torch.equal(chunked.x, direct.x)
    assert torch.equal(chunked.iterations, direct.iterations)
    assert torch.equal(chunked.status, direct.status)
    assert int(direct.iterations[0]) == 47


def test_chunked_batch_matches_monolithic():
    nlp = hs_problem("hs071").nlp
    rng = np.random.default_rng(3)
    x0 = np.clip(nlp.x0 + 0.5 * rng.standard_normal((3, nlp.n)), nlp.x_l, nlp.x_u)
    data = tp.batch_data(nlp, 3, x0=x0, device="cpu")
    direct = tp.make_solver(nlp, PARAMS)(data)
    chunked = solve_with_checkpoints(nlp, PARAMS, data, chunk_iters=5)
    for a, b in zip(direct, chunked):
        if a is not None:
            assert torch.equal(a, b)


def test_checkpoint_resume(tmp_path):
    nlp = toy_nlp()
    ckdir = str(tmp_path / "ck")
    data = tp.batch_data(nlp, 1, device="cpu")
    partial = solve_with_checkpoints(
        nlp, PARAMS.replace(max_iter=3), data, chunk_iters=1, checkpoint_dir=ckdir
    )
    assert int(partial.status[0]) in (
        tp.Status.MAXIMUM_ITERATIONS_EXCEEDED, tp.Status.FEASIBLE_POINT_FOUND
    )
    assert os.listdir(ckdir) == ["sqp_state.pt"]  # no temporary file left behind
    saved = torch.load(os.path.join(ckdir, "sqp_state.pt"), weights_only=True)
    assert int(saved["iter"][0]) == 4 and saved["stats"] is None
    full = solve_with_checkpoints(
        nlp, PARAMS, data, chunk_iters=50, checkpoint_dir=ckdir, resume=True
    )
    np.testing.assert_allclose(full.x.numpy()[0], [-1.0, -1.0], rtol=1e-4)
    # resuming continues the saved state: the count goes on from iteration 4
    assert torch.equal(full.x, tp.make_solver(nlp, PARAMS)(data).x)


def test_warm_start_duals():
    nlp = hs_problem("hs071").nlp
    cold = tp.optimize(nlp, PARAMS, device="cpu")
    data = tp.batch_data(nlp, 1, x0=cold.x[None], device="cpu")
    data.lam0 = torch.as_tensor(cold.mult_g)[None]
    warm = tp.from_raw(tp.make_solver(nlp, PARAMS, verbose=False)(data), 0.0)
    assert warm.iterations <= cold.iterations
    np.testing.assert_allclose(warm.x, cold.x, atol=1e-6)


def test_time_limit():
    nlp = hs_problem("hs071").nlp
    res = solve_with_checkpoints(
        nlp, PARAMS.replace(time_limit=0.0), tp.batch_data(nlp, 2, device="cpu"), chunk_iters=5
    )
    assert res.status.tolist() == [int(tp.Status.MAXIMUM_CPUTIME_EXCEEDED)] * 2


def test_presolve_start_case9():
    nlp = acopf_polar(case9(), scenario_batchable=False)
    solver = tp.make_solver(nlp, ACOPF)
    cold = tp.from_raw(solver(tp.batch_data(nlp, 1, device="cpu")), 0.0)
    warm_data = presolve_start(nlp, ACOPF, device="cpu")
    assert not np.allclose(warm_data.x0.numpy()[0], nlp.x0)
    assert warm_data.lam0 is not None and warm_data.lam0.shape == (1, nlp.m)
    warm = tp.from_raw(solver(warm_data), 0.0)
    assert warm.status == tp.Status.SOLVE_SUCCEEDED, warm.status_name
    np.testing.assert_allclose(warm.obj_val, cold.obj_val, rtol=1e-5)
    np.testing.assert_allclose(warm.obj_val, 5296.69, rtol=1e-4)
    with open(os.path.join(REPO, "sqpsolver_tpu_torch", "data", "anchor_hs.json")) as fh:
        jax_case9 = json.load(fh)["drives"]["case9"]
    np.testing.assert_allclose(cold.obj_val, jax_case9["obj"], rtol=1e-6)
    assert warm.iterations < cold.iterations, (warm.iterations, cold.iterations)


def test_presolve_start_batched():
    case = case9()
    nlp = acopf_polar(case)
    data = tp.batch_data(nlp, 3, theta=load_scenarios(case, 3, seed=11), device="cpu")
    warm = presolve_start(nlp, ACOPF, data=data)
    assert warm.x0.shape == data.x0.shape and warm.lam0.shape == (3, nlp.m)
    summ = tp.summarize_batch(tp.make_batch_solver(nlp, ACOPF)(warm))
    assert summ["n_success"] == 3, summ


def test_presolve_parameters_are_loose():
    pp = presolve_parameters(ACOPF)
    assert pp.tol_infeas > ACOPF.tol_infeas
    assert pp.max_iter <= ACOPF.max_iter
    assert pp.dtype == ACOPF.dtype and pp.OutputFlag == 0
