"""Multi-device solves in one process (``parallel/sharding.py`` and the BBD
block sharding) in the port against the JAX package.

* Instance sharding: toy b16 over ``["cpu"] * 8`` against the JAX package's
  ``make_sharded_solver`` on its fake 8-device CPU mesh
  (``data/anchor_tests.json``, written by ``scripts/torch_anchor.py
  --tests``): status and iterations equal per lane, ``x`` within 1e-8; case9 b8 over
  ``["cpu"] * 4`` against the unsharded port, bit for bit in float64 (a
  shard's lanes run the same arithmetic as in the whole batch); the
  per-shard results come back on ``mesh.devices[0]`` in lane order;
  ``solve_sharded`` refuses a batch the mesh does not divide.
* Block sharding of one structured instance: the coupled case9 problem of
  ``tests/test_block_sharding.py`` (K=4 scenarios, ``kkt_parts=8``, which
  the partition turns into 10 parts) over ``["cpu"] * 8``, against the
  unsharded port and the JAX package's block-sharded solve on its fake mesh
  (``data/anchor_block_sharded_case9.json``) at rtol 1e-6: the separator
  sums run in another order than one ``einsum`` over all parts, so compare
  at solver tolerance, as the JAX test does.  The part groups, the
  ``bbd_factorize`` of one random BBD system split over three groups, and
  the refusals (``kkt_structured=False``, ``kkt_parts`` not a multiple of
  the mesh).
"""

import json
import os

import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.power import case9
from sqpsolver_tpu_torch.models.stochastic import couple_scenarios, pg_shared_mask
from sqpsolver_tpu_torch.models.toy import toy_nlp
from sqpsolver_tpu_torch.ops import kkt_bbd
from sqpsolver_tpu_torch.parallel import sharding as shd

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sqpsolver_tpu_torch", "data")
TOY = dict(max_iter=200, OutputFlag=0)
#: ``tests/test_multiprocess.py``'s fleet parameters
CASE9 = dict(max_iter=40, OutputFlag=0, tol_infeas=1e-6, tol_residual=1e-4,
             init_projection="off")


def _anchor(name):
    with open(os.path.join(DATA, name)) as fh:
        return json.load(fh)


def test_toy_sharded_matches_jax_fake_mesh():
    anchor = _anchor("anchor_tests.json")["toy_sharded_b16"]
    x0, want = np.asarray(anchor["x0"]), anchor["lanes"]
    nlp = toy_nlp()
    mesh = shd.instance_mesh(["cpu"] * anchor["devices"])
    data = shd.shard_data(tp.batch_data(nlp, len(x0), x0=x0, device="cpu"), mesh)
    assert [int(s.x0.shape[0]) for s in data.shards] == [2] * 8
    got = shd.make_sharded_solver(nlp, tp.Parameters(**anchor["params"]), mesh)(data)
    assert got.x.shape == (16, 2) and got.x.device == torch.device("cpu")
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want["status"]))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want["iterations"]))
    assert len(set(got.iterations.tolist())) > 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want["x"]), rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def case9_b8():
    case = case9()
    nlp = acopf_polar(case)
    theta = load_scenarios(case, 8, seed=7, spread=0.03)
    data = tp.batch_data(nlp, 8, theta=theta, device="cpu")
    return nlp, data, tp.make_batch_solver(nlp, tp.Parameters(**CASE9))(data)


def test_case9_sharded_is_the_unsharded_solve_bit_for_bit(case9_b8):
    nlp, data, whole = case9_b8
    mesh = shd.instance_mesh(["cpu"] * 4)
    got = shd.make_sharded_solver(nlp, tp.Parameters(**CASE9), mesh)(data)
    assert got.status.tolist() == [0] * 8
    for field in ("x", "obj_val", "status", "iterations", "qp_iters_total", "mult_g"):
        assert torch.equal(getattr(got, field), getattr(whole, field)), field


def test_solve_sharded_builds_and_splits_the_batch(case9_b8):
    nlp, data, whole = case9_b8
    theta = load_scenarios(case9(), 8, seed=7, spread=0.03)
    got = shd.solve_sharded(nlp, tp.Parameters(**CASE9), 8, theta=theta,
                            mesh=shd.instance_mesh(["cpu"] * 2))
    assert torch.equal(got.x, whole.x) and torch.equal(got.iterations, whole.iterations)


def test_solve_sharded_refuses_a_batch_the_mesh_does_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        shd.solve_sharded(toy_nlp(), tp.Parameters(**TOY), 6, mesh=shd.instance_mesh(["cpu"] * 4))


def test_instance_mesh_takes_the_card_unless_named():
    mesh = shd.instance_mesh(["cpu", "cpu"], axis="block")
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.axis == "block"
    assert (mesh.rank, mesh.world, mesh.size) == (0, 1, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shd.instance_mesh()


def test_part_groups_split_by_part_index():
    cpu = torch.device("cpu")
    assert kkt_bbd.part_groups(8, ["cpu"] * 2) == ((cpu, slice(0, 4)), (cpu, slice(4, 8)))
    sizes = [g[1].stop - g[1].start for g in kkt_bbd.part_groups(10, ["cpu"] * 8)]
    assert sizes == [2, 2, 1, 1, 1, 1, 1, 1]
    assert len(kkt_bbd.part_groups(2, ["cpu"] * 4)) == 2


def test_bbd_factor_split_over_groups_solves_the_same_system():
    rng = np.random.default_rng(7)
    P, nd, ns = 3, 8, 5
    G = rng.standard_normal((P, nd, nd))
    K_pp = G @ G.transpose(0, 2, 1) / nd + np.eye(nd)
    K_ps = 0.2 * rng.standard_normal((P, nd, ns))
    K_ss = 4.0 * np.eye(ns)
    r_pp, r_ss = rng.standard_normal((P, nd)), rng.standard_normal(ns)
    t = [torch.as_tensor(a)[None] for a in (K_pp, K_ps, K_ss, r_pp, r_ss)]
    one = kkt_bbd.bbd_factorize(*t[:3], torch.zeros(1, dtype=torch.float64), 0.0)
    groups = kkt_bbd.part_groups(P, ["cpu"] * 3)
    split = kkt_bbd.bbd_factorize(*t[:3], torch.zeros(1, dtype=torch.float64), 0.0,
                                  groups=groups)
    assert len(split.Li_pp) == 3 and bool(split.ok[0])
    x1 = torch.cat([a.flatten() for a in kkt_bbd.bbd_solve(one, *t[3:])])
    x3 = torch.cat([a.flatten() for a in kkt_bbd.bbd_solve(split, *t[3:])])
    torch.testing.assert_close(x3, x1, rtol=1e-13, atol=1e-13)


@pytest.fixture(scope="module")
def coupled():
    anchor = _anchor("anchor_block_sharded_case9.json")
    cp = anchor["coupled"]
    base9 = case9()
    base = acopf_polar(base9)
    thetas = load_scenarios(base9, cp["K"], seed=cp["seed"], spread=cp["spread"])
    nlp = couple_scenarios(base, thetas, pg_shared_mask(base9, base))
    assert (nlp.n, nlp.m) == (anchor["n"], anchor["m"])
    return anchor, nlp, tp.Parameters(**anchor["params"])


def test_block_sharded_coupled_matches_unsharded_and_jax(coupled):
    anchor, nlp, params = coupled
    data = tp.batch_data(nlp, 1, device="cpu")
    base = tp.from_raw(tp.make_solver(nlp, params)(data), 0.0)
    mesh = shd.instance_mesh(["cpu"] * 8, axis="block")
    sharded = tp.from_raw(shd.make_block_sharded_solver(nlp, params, mesh)(data), 0.0)
    for res in (base, sharded):
        assert res.success, res.status_name
        assert float(res.prim_infeas) < 1e-6
    np.testing.assert_allclose(sharded.obj_val, base.obj_val, rtol=1e-6)
    for name in ("block_sharded", "unsharded"):
        want = anchor["solves"][name]
        assert want["status"] == 0
        np.testing.assert_allclose(sharded.obj_val, want["obj"], rtol=1e-6)
        np.testing.assert_allclose(base.obj_val, want["obj"], rtol=1e-6)


def test_block_sharded_requires_structured(coupled):
    _, nlp, params = coupled
    with pytest.raises(ValueError, match="kkt_structured"):
        shd.make_block_sharded_solver(
            acopf_polar(case9()), params.replace(kkt_structured=False),
            shd.instance_mesh(["cpu"] * 8),
        )
    with pytest.raises(ValueError, match="kkt_parts"):
        shd.make_block_sharded_solver(nlp, params.replace(kkt_parts=6),
                                      shd.instance_mesh(["cpu"] * 4))
