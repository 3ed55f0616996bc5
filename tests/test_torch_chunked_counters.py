"""The chunked solver's process-wide counters and spans
(``make_chunked_batch_solver.rounds``, ``pass_seconds``,
``fallback_lanes``, ``fallback_rounds``) against what each call's
``solve.stats`` says, on hs071 (``hs071_problem.py``) at six lanes.

The rescue fallback is forced as ``test_torch_chunked.py`` forces it: the
first pass's solver reports ``Error_In_Step_Computation`` on the odd lanes,
and the twin (``qp_rescue=True``) runs the true solver.
"""

import time

import pytest
import torch
from hs071_problem import B, X0, hs071, starts

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.nlp import build_nlp
from sqpsolver_tpu_torch.parallel import batch as batch_mod
from sqpsolver_tpu_torch.status import Status

PARAMS = tp.Parameters(max_iter=15, OutputFlag=0, qp_rescue=False)
CHUNKED = tp.make_chunked_batch_solver
MAKE_SOLVER = batch_mod.make_solver


@pytest.fixture(scope="module")
def nlp():
    return hs071(build_nlp, torch)


@pytest.fixture
def data(nlp):
    return tp.batch_data(nlp, B, x0=starts(1.0e-3), device="cpu")


def snapshot():
    return dict(rounds=CHUNKED.rounds, fallback_lanes=CHUNKED.fallback_lanes,
                fallback_rounds=CHUNKED.fallback_rounds, **CHUNKED.pass_seconds)


def timed_call(solver, data):
    """The call's wall time and the counters' deltas over it."""
    before = snapshot()
    t0 = time.perf_counter()
    solver(data)
    wall = time.perf_counter() - t0
    after = snapshot()
    return wall, {k: after[k] - before[k] for k in before}


def failing_make_solver(nlp_, params_):
    """The first pass's solver reports a stalled step on the odd lanes."""
    s = MAKE_SOLVER(nlp_, params_)
    if params_.qp_rescue:
        return s  # the rescue twin runs the true solver
    finalize = s.finalize

    def stalled_odd_lanes(st, d):
        res = finalize(st, d)
        odd = torch.round((d.x0[:, 0] - X0[0]) * 1.0e3).to(torch.int64) % 2 == 1
        bad = torch.full_like(res.status, int(Status.ERROR_IN_STEP_COMPUTATION))
        return res._replace(status=torch.where(odd, bad, res.status))

    s.finalize = stalled_odd_lanes
    return s


@pytest.mark.parametrize("sub_batch", [0, 2])
def test_counters_follow_the_stats_of_a_call_with_a_fallback(nlp, data, monkeypatch, sub_batch):
    monkeypatch.setattr(batch_mod, "make_solver", failing_make_solver)
    solver = CHUNKED(nlp, PARAMS, chunk0=5, sub_batch=sub_batch, rescue_fallback=True)
    wall, d = timed_call(solver, data)
    stats = solver.stats
    assert stats["fallback_lanes"] == [1, 3, 5] and stats["fallback_rounds"] > 0
    assert d["rounds"] == stats["rounds"] + stats["fallback_rounds"]
    assert d["fallback_lanes"] == len(stats["fallback_lanes"])
    assert d["fallback_rounds"] == stats["fallback_rounds"]
    assert d["first"] > 0 and d["fallback"] > 0
    assert d["first"] + d["fallback"] <= wall


def test_a_call_without_a_fallback_counts_only_its_first_pass(nlp, data):
    solver = CHUNKED(nlp, PARAMS, chunk0=5, rescue_fallback=True)
    wall, d = timed_call(solver, data)
    assert solver.stats["fallback_lanes"] == []  # every lane ran out its 15 iterations
    assert d["rounds"] == solver.stats["rounds"] > 0
    assert d["fallback"] == 0 and d["fallback_lanes"] == 0 and d["fallback_rounds"] == 0
    assert 0 < d["first"] <= wall
