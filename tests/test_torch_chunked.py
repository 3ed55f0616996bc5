"""The port's chunked batch solver, its rescue fallback, the state helpers
and the Lanczos shift, against the JAX package and against the port's own
monolithic solver.

The problem is hs071 (four variables in [1, 5], x1 x2 x3 x4 >= 25, sum of
squares = 40; f* = 17.0140173), written out in ``hs071_problem.py`` for both
packages through their ``build_nlp``; six lanes start from shifted points.

* chunked equals monolithic **bit for bit** in the port, for ``chunk0`` in
  {1, 5} and ``sub_batch`` in {0, 2} (the work queue with slabs narrower than
  the batch) over the first 15 iterations, and to convergence with staggered
  starts under ``qp_rescue=True`` (lanes that finish early leave a slab
  smaller than ``sub_batch``; the loop must end);
* the rescue fallback merges exactly: with a first pass made to report
  ``Error_In_Step_Computation`` on the odd lanes, those lanes equal a
  rescue-enabled solve bit for bit and the even lanes equal the first pass
  (15 iterations: the merge does not care how a lane ended);
* ``mixed_ir`` with ``qp_rescue=True``, and ``mixed_polish`` at 1e-8
  tolerances, against the JAX package's batched solver (its lanes, the
  parameters and the starts stored by ``scripts/torch_anchor.py --tests`` in
  ``data/anchor_tests.json``): status equal, objective within 1e-8
  relative, x within 1e-6;
* a JAX solver state taken after two iterations, carried over by
  ``sqp_state_to_torch``, continues in the port to the state the JAX package
  reaches (floats within 1e-7, relative or absolute: two more iterations of QPs solved
  to 1e-8 by two codes; flags and counters equal), and
  ``gather_lanes`` / ``scatter_lanes`` move exactly the lanes asked for;
* ``lanczos_lmin_bound`` from the JAX package's start vector: within 1e-6
  relative of the JAX bound in float64, before and after the Krylov space is
  full, with a zero operator (immediate breakdown) in the batch.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hs071_problem import B, X0, hs071, starts

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.algorithms import common as j_common
from sqpsolver_tpu.algorithms.sqp_tr import make_solver as j_make_solver
from sqpsolver_tpu.nlp import build_nlp as j_build
from sqpsolver_tpu.parallel import batch as j_batch
from sqpsolver_tpu.parameters import Parameters as JParameters
from sqpsolver_tpu_torch._lanes import gather_lanes, scatter_lanes
from sqpsolver_tpu_torch.algorithms import common as t_common
from sqpsolver_tpu_torch.algorithms.sqp_tr import SqpState, make_solver
from sqpsolver_tpu_torch.nlp import build_nlp as t_build
from sqpsolver_tpu_torch.ops.qp_ipm import solve_qp
from sqpsolver_tpu_torch.parallel import batch as batch_mod
from sqpsolver_tpu_torch.status import Status

KW = dict(max_iter=200, OutputFlag=0, qp_rescue=False)
SHORT = dict(KW, max_iter=15)
ANCHOR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "sqpsolver_tpu_torch", "data", "anchor_tests.json")


@pytest.fixture(scope="module")
def nlp():
    return hs071(t_build, torch)


def assert_results_equal(a, b, lanes=slice(None)):
    for key, val in a._asdict().items():
        if val is not None:
            assert torch.equal(val[lanes], getattr(b, key)[lanes]), key


@pytest.fixture(scope="module")
def short_mono(nlp):
    data = tp.batch_data(nlp, B, x0=starts(1.0e-3), device="cpu")
    return data, tp.make_batch_solver(nlp, tp.Parameters(**SHORT))(data)


@pytest.mark.parametrize("chunk0", [1, 5])
@pytest.mark.parametrize("sub_batch", [0, 2])
def test_chunked_equals_monolithic(nlp, short_mono, chunk0, sub_batch):
    data, mono = short_mono
    solver = tp.make_chunked_batch_solver(
        nlp, tp.Parameters(**SHORT), chunk0=chunk0, sub_batch=sub_batch
    )
    res = solver(data)
    assert_results_equal(res, mono)
    assert (mono.iterations == 16).all()
    slabs = 1 if sub_batch == 0 else B // sub_batch
    assert solver.stats["rounds"] == slabs * 15 // chunk0
    assert solver.stats["fallback_lanes"] == []


def test_narrow_last_slab_terminates(nlp):
    """Staggered convergence with one-iteration rounds and fewer lanes left
    than the slab is wide: each round's limit keys on the lanes it advances,
    so the loop ends, on the monolithic result."""
    params = tp.Parameters(**dict(KW, qp_rescue=True))
    data = tp.batch_data(nlp, B, x0=starts(2.0e-2), device="cpu")
    solver = tp.make_chunked_batch_solver(nlp, params, sub_batch=4)
    res = solver(data)
    iters = res.iterations.numpy()
    assert iters.max() - iters.min() >= 1, iters  # stragglers existed
    assert_results_equal(res, tp.make_batch_solver(nlp, params)(data))
    assert (res.status == 0).all()
    np.testing.assert_allclose(res.obj_val.numpy(), 17.0140173, rtol=1e-6)


def test_rescue_fallback_merge_exact(nlp, short_mono, monkeypatch):
    params = tp.Parameters(**SHORT)
    data, fast = short_mono
    real_make_solver = batch_mod.make_solver

    def failing_make_solver(nlp_, params_):
        s = real_make_solver(nlp_, params_)
        if params_.qp_rescue:
            return s  # the rescue twin runs the true solver
        orig_fin = s.finalize

        def finalize(st, d):
            res = orig_fin(st, d)
            odd = torch.round((d.x0[:, 0] - X0[0]) * 1.0e3).to(torch.int64) % 2 == 1
            bad = torch.full_like(res.status, int(Status.ERROR_IN_STEP_COMPUTATION))
            return res._replace(status=torch.where(odd, bad, res.status))

        s.finalize = finalize
        return s

    monkeypatch.setattr(batch_mod, "make_solver", failing_make_solver)
    solver = tp.make_chunked_batch_solver(nlp, params, chunk0=5, rescue_fallback=True)
    merged = solver(data)
    monkeypatch.setattr(batch_mod, "make_solver", real_make_solver)

    rescue = tp.make_chunked_batch_solver(nlp, params.replace(qp_rescue=True), chunk0=5)(data)
    assert solver.stats["fallback_lanes"] == [1, 3, 5]
    assert solver.stats["fallback_rounds"] > 0
    assert_results_equal(merged, rescue, [1, 3, 5])
    assert_results_equal(merged, fast, [0, 2, 4])
    assert (merged.status != int(Status.ERROR_IN_STEP_COMPUTATION)).all()

    # nothing failed: the twin is never built and the result is the plain one
    plain = tp.make_chunked_batch_solver(nlp, params, chunk0=5, rescue_fallback=True)
    assert_results_equal(plain(data), fast)
    assert plain.stats["fallback_lanes"] == []


@pytest.mark.parametrize("name", ["mixed_ir_rescue", "mixed_polish"])
def test_float64_phase_solves_match_jax(nlp, name):
    with open(ANCHOR) as fh:
        anchor = json.load(fh)["chunked_hs071_b3"]
    kw = anchor["params"][name]
    x0 = starts(anchor["step"])[:anchor["batch"]]
    jr = anchor["runs"][name]
    solver = tp.make_chunked_batch_solver(nlp, tp.Parameters(**kw), chunk0=3)
    trips0 = solve_qp.loop_trips[2]
    tr = solver(tp.batch_data(nlp, len(x0), x0=x0, device="cpu"))
    if kw["kkt_precision"] == "mixed_polish":
        assert solve_qp.loop_trips[2] > trips0  # the float64 phase ran
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr["status"]))
    assert (tr.status.numpy() == 0).all()
    np.testing.assert_allclose(tr.obj_val.numpy(), np.asarray(jr["obj"]), rtol=1e-8)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr["x"]), atol=1e-6)


def test_state_carries_over_from_jax(nlp):
    params = dict(max_iter=200, OutputFlag=0)
    x0 = starts(1.0e-3)[:4]
    j_nlp = hs071(j_build, jnp)
    j_solver = j_make_solver(j_nlp, JParameters(**params), verbose=False)
    j_data = j_batch.batch_data(j_nlp, 4, x0=x0)
    j_run = jax.jit(jax.vmap(j_solver._run_until, in_axes=(0, 0, None)))
    j_mid = j_run(jax.vmap(j_solver._init_state)(j_data), j_data, jnp.asarray(2, jnp.int32))
    j_end = j_run(j_mid, j_data, jnp.asarray(4, jnp.int32))

    t_solver = make_solver(nlp, tp.Parameters(**params))
    t_data = tp.batch_data(nlp, 4, x0=x0, device="cpu")
    mid = tp.sqp_state_to_torch(j_mid, device="cpu")
    assert isinstance(mid, SqpState) and mid.iter.dtype == torch.int32 and mid.done.dtype == torch.bool
    assert mid.iter.tolist() == [3, 3, 3, 3]
    end = tp.sqp_state_to_numpy(t_solver.run_until(mid, t_data, 4))
    assert j_end.stats is None and end["stats"] is None  # StatisticsFlag off
    for f in dataclasses.fields(SqpState):
        if f.name == "stats":
            continue
        want = np.asarray(getattr(j_end, f.name))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(end[f.name], want, rtol=1e-7, atol=1e-7, err_msg=f.name)
        else:
            np.testing.assert_array_equal(end[f.name], want, err_msg=f.name)

    # gather / scatter move exactly the lanes asked for, in every field
    idx = torch.tensor([3, 1])
    slab = gather_lanes(mid, idx)
    back = scatter_lanes(tp.sqp_state_to_torch(j_end, device="cpu"), slab, idx)
    assert slab.stats is None and back.stats is None
    for f in dataclasses.fields(SqpState):
        if f.name == "stats":
            continue
        a_mid, a_end = np.asarray(getattr(j_mid, f.name)), np.asarray(getattr(j_end, f.name))
        np.testing.assert_array_equal(getattr(slab, f.name).numpy(), a_mid[[3, 1]], err_msg=f.name)
        want = a_end.copy()
        want[[3, 1]] = a_mid[[3, 1]]
        np.testing.assert_array_equal(getattr(back, f.name).numpy(), want, err_msg=f.name)
    d_slab = gather_lanes(t_data, idx)
    assert torch.equal(d_slab.x0, t_data.x0[idx]) and d_slab.theta is None


@pytest.mark.parametrize("iters", [6, 8, 12])
def test_lanczos_bound_matches_jax(iters):
    n = 12
    rng = np.random.default_rng(iters)
    H = rng.standard_normal((4, n, n))
    H = 0.5 * (H + H.transpose(0, 2, 1))
    H[2] += 6.0 * np.eye(n)  # one definite lane
    H[3] = 0.0  # immediate breakdown: beta = 0 at the first step
    v0 = jax.random.normal(jax.random.PRNGKey(20240819), (n,), jnp.float64)
    v0 = np.array(v0 / jnp.linalg.norm(v0))  # a writable copy
    want = np.asarray(jax.vmap(
        lambda Hi: j_common.lanczos_lmin_bound(lambda v: Hi @ v, n, jnp.float64, iters=iters)
    )(jnp.asarray(H)))
    Ht = torch.as_tensor(H)
    got = t_common.lanczos_lmin_bound(
        lambda v: torch.matmul(Ht, v[:, :, None])[:, :, 0], 4, n, torch.float64, "cpu",
        iters=iters, v0=torch.as_tensor(v0),
    ).numpy()
    lmin = np.linalg.eigvalsh(H)[:, 0]
    assert got[3] == 0.0 and want[3] == 0.0
    scale = np.abs(np.linalg.eigvalsh(H)).max(-1)
    assert (np.abs(got - want)[:3] <= 1e-6 * scale[:3]).all(), (got, want)
    if iters >= n:
        # the Krylov space is full: the bound is lambda_min less the pad, from
        # the JAX start vector and from the port's own alike
        own = t_common.lanczos_lmin_bound(
            lambda v: torch.matmul(Ht, v[:, :, None])[:, :, 0], 4, n, torch.float64, "cpu",
            iters=iters,
        ).numpy()
        for bound in (got, own):
            assert (bound <= lmin + 1e-12).all()
            np.testing.assert_allclose(bound[:3], lmin[:3], rtol=0, atol=2e-5 * scale[:3].max())
