"""The SQP-TR iteration written as stretches between its host points
(``ops/stretches.py``; the QP call, the ``eigh`` shift's eigenvalue call, the
SOC's QP call, a one-lane solve's iteration line, the loop's sync), on the
CPU, on ACOPF case9.

* Under plain calls the stretches give the answers the iteration gave before
  it was split, bit for bit: statuses, iterations, QP trips, ``x``,
  objectives, multipliers, ``any_lane.syncs`` and the printed iteration lines
  (recorded on that version), for 4 scenarios under
  ``sqpbench/configs/case30_scenarios.json``'s parameters and for one
  scenario under ``case30_dispatch.json``'s (the ``eigh`` shift, the SOC).
* The graph path's bookkeeping, with the CPU stand-in for the CUDA graph
  (``qp_batches.CpuReplay``: a replay runs the function of the first call
  that captured the stretch again): two calls on other data, with a call of
  another batch width between them, give the plain path's answers bit for
  bit and the same syncs, and the repeated shape replays what its first call
  captured.  So does the chunked solver, whose slabs narrow as lanes finish.
* Two models of one shape, each with its own solver, never share a stage
  graph: each solve replays only what its own solver captured, and gives its
  own model's plain answers.
"""

import dataclasses
import hashlib
import json
import pathlib

import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch._lanes import any_lane
from sqpsolver_tpu_torch.algorithms import sqp_tr
from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
from sqpsolver_tpu_torch.models.power import case9
from sqpsolver_tpu_torch.ops import qp_ipm, stretches

from qp_batches import CpuReplay, trip_plans

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: recorded by the SQP-TR iteration before it was split into stretches
PARENT = {
    "b4": dict(
        status=[0, 0, 0, 0], iterations=[9, 16, 8, 7], qp_iters_total=[107, 196, 92, 60],
        x_sum=51.37631372410875, mult_g_sum=-87676.91922996897, syncs=1264,
        obj=[5106.175600955791, 5212.600933727205, 5389.541011641674, 5335.240346741735],
    ),
    "one_lane": dict(
        status=[0], iterations=[15], qp_iters_total=[165], x_sum=12.965128084718975,
        mult_g_sum=-22405.87534249932, syncs=539, obj=[5446.950291865494],
        # the 15 printed lines without their time column
        log="5e74efb59a6ae7104e76554f2013d263db82fd6e1af3fc7928fa604a3e0b198c",
    ),
}


def _parameters(config):
    path = ROOT / "sqpbench" / "configs" / f"{config}.json"
    return tp.Parameters(**json.loads(path.read_text())["parameters"])


def _one_lane_model(seed):
    """One case9 scenario with its loads built into the model, as the
    ``case30_dispatch`` configuration builds case30's."""
    case = case9()
    theta = load_scenarios(case, 1, seed=seed, spread=0.03)
    one = dataclasses.replace(case, bus_pd=theta["pd"][0], bus_qd=theta["qd"][0])
    return acopf_polar(one, scenario_batchable=False)


def _b4_calls():
    """A batch solver under the scenario cells' parameters and its calls:
    4 scenarios, 2 others, 4 others."""
    nlp = acopf_polar(case9())
    solver = tp.make_batch_solver(nlp, _parameters("case30_scenarios"))

    def call(batch, seed):
        theta = load_scenarios(case9(), batch, seed=seed, spread=0.03)
        return lambda: solver(tp.batch_data(nlp, batch, theta=theta, device="cpu"))

    return solver, [call(4, 3), call(2, 4), call(4, 5)]


def _one_lane_calls(verbose=False):
    """A one-lane solver under the dispatch parameters (``eigh`` shift, SOC)
    and its calls: one lane, two lanes, one lane at other data."""
    nlp = _one_lane_model(5)
    solver = tp.make_solver(nlp, _parameters("case30_dispatch"), verbose=verbose)

    def call(batch, x0_scale):
        data = tp.batch_data(nlp, batch, device="cpu")
        data.x0 = data.x0 * x0_scale
        return lambda: solver(data)

    return solver, [call(1, 1.0), call(2, 1.0), call(1, 1.02)]


def _chunked_calls():
    """The chunked solver, three lanes a slab and three iterations a round,
    over 4 scenarios."""
    nlp = acopf_polar(case9())
    solver = tp.make_chunked_batch_solver(
        nlp, _parameters("case30_scenarios"), chunk0=3, sub_batch=3
    )

    def call(seed):
        theta = load_scenarios(case9(), 4, seed=seed, spread=0.03)
        return lambda: solver(tp.batch_data(nlp, 4, theta=theta, device="cpu"))

    return solver, [call(3)]


def _solved(fn):
    s0 = any_lane.syncs
    res = fn()
    fields = {k: v.clone() for k, v in res._asdict().items() if torch.is_tensor(v)}
    return fields, any_lane.syncs - s0


@pytest.mark.parametrize("name", list(PARENT))
def test_stretches_give_the_parents_answers(name, capsys):
    want = PARENT[name]
    _, calls = _b4_calls() if name == "b4" else _one_lane_calls(verbose=True)
    got, syncs = _solved(calls[0])
    assert syncs == want["syncs"]
    for k in ("status", "iterations", "qp_iters_total"):
        assert got[k].tolist() == want[k], k
    assert got["obj_val"].tolist() == want["obj"]
    assert float(got["x"].sum()) == want["x_sum"]
    assert float(got["mult_g"].sum()) == want["mult_g_sum"]
    if "log" in want:
        lines = [line[:-12] for line in capsys.readouterr().out.splitlines()]
        assert hashlib.sha256("\n".join(lines).encode()).hexdigest() == want["log"]


@pytest.fixture
def stand_in(monkeypatch):
    """The CPU stand-in for CUDA-graphed stage runs, with fresh counters and
    the QP trip's runs left plain; ``plain(fn)`` runs ``fn`` with every
    solver's stage graphs switched off."""
    monkeypatch.setattr(stretches, "Graphed", CpuReplay)
    monkeypatch.setattr(qp_ipm, "_PLANS", trip_plans(graphs=False))
    monkeypatch.setattr(sqp_tr.stage_graphs, "graph_captures", 0)
    monkeypatch.setattr(sqp_tr.stage_graphs, "graph_replays", 0)

    def plain(fn):
        monkeypatch.setattr(stretches.Plans, "graphs", False)
        try:
            return _solved(fn)
        finally:
            monkeypatch.setattr(stretches.Plans, "graphs", True)

    return plain


def _assert_same(got, want, where):
    for k in want:
        assert torch.equal(got[k], want[k]), (where, k)


@pytest.mark.parametrize("name", ["b4", "one_lane", "chunked"])
def test_replayed_stages_match_plain_calls(name, stand_in):
    make = dict(b4=_b4_calls, one_lane=_one_lane_calls, chunked=_chunked_calls)[name]
    _, calls = make()
    plain = [stand_in(fn) for fn in calls]
    tally = sqp_tr.stage_graphs
    assert tally.graph_captures == tally.graph_replays == 0

    solver, calls = make()
    counts = []
    for i, fn in enumerate(calls):
        before = (tally.graph_captures, tally.graph_replays)
        got, syncs = _solved(fn)
        counts.append((tally.graph_captures - before[0], tally.graph_replays - before[1]))
        assert syncs == plain[i][1], i
        _assert_same(got, plain[i][0], i)
    if name != "chunked":
        # one run a batch width; the third call replays the first one's
        assert len(solver.stage_plans) == 2
        assert counts[2][0] == 0 and counts[2][1] > 0
    assert tally.graph_captures > 0
    assert tally.graph_replays > 5 * tally.graph_captures, (tally, counts)


def test_two_models_of_one_shape_keep_their_own_graphs(stand_in):
    params = _parameters("case30_dispatch")
    models = [_one_lane_model(5), _one_lane_model(6)]
    datas = [tp.batch_data(m, 1, device="cpu") for m in models]
    plain = [stand_in(lambda: tp.make_solver(m, params)(d)) for m, d in zip(models, datas)]
    assert not torch.equal(plain[0][0]["x"], plain[1][0]["x"])

    solvers = [tp.make_solver(m, params) for m in models]
    # each model's solver in turn, twice
    for i in (0, 1, 0, 1):
        got, syncs = _solved(lambda: solvers[i](datas[i]))
        assert syncs == plain[i][1]
        _assert_same(got, plain[i][0], i)
    runs = [set(map(id, s.stage_plans.values())) for s in solvers]
    assert len(runs[0]) == len(runs[1]) == 1 and not runs[0] & runs[1]
