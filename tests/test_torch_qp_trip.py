"""The dense IPM trip written as stretches between host points
(``ops/stretches.py``), on the CPU.

A small dense batch whose ladders escalate and bisect on some lanes only
(lanes 1, 3 and 5 carry an indefinite direction in Q; lanes 0, 2 and 4 are
convex) is solved under five option sets: float32 kernel-path factors with
and without the Schur cap, float64 library factors, the float32 plane, and
a float64 polish phase after a float32 one.

* The host points are the ones the IPM had before it was split into
  stretches: ``any_lane.syncs``, ``solve_qp.loop_trips`` and
  ``cholesky_blocked.calls`` equal the numbers that version recorded on this
  batch, and so do the iteration counts and converged flags.
* The graph path's bookkeeping, with a CPU stand-in for the CUDA graph: a
  stretch's "capture" runs it and writes its outputs into the slots, and a
  "replay" runs the function of the FIRST call that captured it again, with
  copy-in writes, so a stretch that held a tensor of its own call, or wrote
  into a tensor another slot reads, would go wrong.  Two calls on other data
  and a call of another shape in between give the plain path's answers bit
  for bit, the same syncs, and replays where the shapes repeat.
* The cache of graphed runs (``stretches.Plans``) drops its least recently
  used run past its count limit or its share of the card's memory, never
  its only run, and hands out plain calls where graphs are off.
"""

import types

import numpy as np
import pytest
import torch

from sqpsolver_tpu_torch._lanes import any_lane
from sqpsolver_tpu_torch.ops import chol_blocked, qp_ipm, stretches

from qp_batches import M, N, OPTS, CpuReplay, escalating_qps as _qps, trip_plans

T, F = True, False
#: recorded on seed 7 by the IPM before its trip was split into stretches
PARENT = {
    "f32_cap": dict(syncs=402, trips={1: 30, 2: 0}, factorizations=535,
                    iters=[13, 30, 12, 25, 14, 17], converged=[T, F, T, F, T, F],
                    p_sum=-0.19381945062284167, y_sum=-108321075.15731935),
    "f32": dict(syncs=406, trips={1: 30, 2: 0}, factorizations=543,
                iters=[13, 19, 12, 30, 14, 17], converged=[T, F, T, F, T, F],
                p_sum=0.3535732579521751, y_sum=-108321032.76357919),
    "f64": dict(syncs=232, trips={1: 22, 2: 0}, factorizations=0,
                iters=[14, 22, 13, 20, 15, 16], converged=[T, F, T, F, T, F],
                p_sum=0.34264073642863746, y_sum=-108321071.30785245),
    "plane_cap": dict(syncs=290, trips={1: 25, 2: 0}, factorizations=388,
                      iters=[13, 22, 12, 25, 14, 17], converged=[T, T, T, F, T, F],
                      p_sum=-0.19381647013783976, y_sum=-108321075.21763499),
    "polish": dict(syncs=483, trips={1: 25, 2: 20}, factorizations=396,
                   iters=[14, 19, 13, 20, 15, 16], converged=[T, T, T, F, T, F],
                   p_sum=0.3426407560501712, y_sum=-108321072.91005845),
}


def _counted(fn):
    s0, t0 = any_lane.syncs, dict(qp_ipm.solve_qp.loop_trips)
    f0 = chol_blocked.cholesky_blocked.calls
    out = fn()
    return out, dict(
        syncs=any_lane.syncs - s0,
        trips={k: qp_ipm.solve_qp.loop_trips[k] - t0[k] for k in t0},
        factorizations=chol_blocked.cholesky_blocked.calls - f0,
    )


@pytest.mark.parametrize("name", list(OPTS))
def test_split_trip_gives_the_parents_counts(name, monkeypatch):
    want = PARENT[name]
    goes, names = [], []
    sync, stretch = stretches.Eager.sync, stretches.Eager.stretch

    def spy_sync(self, key):
        if key.endswith(".go"):
            goes.append(self.slots[key].clone())
        return sync(self, key)

    def spy_stretch(self, key, fn):
        names.append(key)
        return stretch(self, key, fn)

    monkeypatch.setattr(stretches.Eager, "sync", spy_sync)
    monkeypatch.setattr(stretches.Eager, "stretch", spy_stretch)
    arrs = _qps(7)
    sol, counts = _counted(lambda: qp_ipm.solve_qp(*arrs, opts=qp_ipm.IpmOptions(**OPTS[name])))
    assert counts == {k: want[k] for k in ("syncs", "trips", "factorizations")}
    assert sol.iters.tolist() == want["iters"]
    assert sol.converged.tolist() == want["converged"]
    assert float(sol.p.sum()) == pytest.approx(want["p_sum"], rel=1e-12, abs=0)
    assert float(sol.y.sum()) == pytest.approx(want["y_sum"], rel=1e-12, abs=0)
    # the ladders escalate on the lanes with an indefinite direction only,
    # and bisect
    rungs = torch.stack(goes).sum(0)
    assert (rungs[[1, 3, 5]] > 0).all() and (rungs[[0, 2, 4]] == 0).all()
    assert any(k.endswith("K.bisect_last") for k in names)


def _fields(sol):
    return {k: v.clone() for k, v in sol._asdict().items()}


@pytest.mark.parametrize("name", list(OPTS))
def test_replayed_stretches_match_plain_calls(name, monkeypatch):
    opts = qp_ipm.IpmOptions(**OPTS[name])
    rng = np.random.default_rng(11)
    warm = dict(
        skip=torch.tensor([False, False, True, False, False, False]),
        init=dict(p=torch.as_tensor(rng.standard_normal((6, N)) * 0.1),
                  y=torch.as_tensor(rng.standard_normal((6, M))),
                  zl=torch.ones(6, N, dtype=torch.float64),
                  zu=torch.ones(6, N, dtype=torch.float64),
                  on=torch.tensor([True, False] * 3)),
    )
    calls = [(_qps(7), {}), (_qps(8, 3), {}), (_qps(9), warm)]
    plain = [
        _counted(lambda: _fields(qp_ipm.solve_qp(*arrs, opts=opts, **kw))) for arrs, kw in calls
    ]

    monkeypatch.setattr(stretches, "Graphed", CpuReplay)
    monkeypatch.setattr(qp_ipm, "_PLANS", trip_plans())
    monkeypatch.setattr(qp_ipm.solve_qp, "graph_captures", 0)
    monkeypatch.setattr(qp_ipm.solve_qp, "graph_replays", 0)
    # the first shape twice around another shape, then the first shape warm
    order = [0, 1, 0, 2]
    for i in order:
        arrs, kw = calls[i]
        got, counts = _counted(lambda: _fields(qp_ipm.solve_qp(*arrs, opts=opts, **kw)))
        want, want_counts = plain[i]
        assert counts == want_counts
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    assert len(qp_ipm._PLANS) == 3
    captures = qp_ipm.solve_qp.graph_captures
    replays = qp_ipm.solve_qp.graph_replays
    assert captures > 0 and replays > 10 * captures


def _plan(plans, width):
    return plans.run(torch.device("cpu"), None, {"x": torch.zeros(width)})


@pytest.mark.parametrize("case", ["count", "memory", "single", "off"])
def test_plans_evict_the_least_recently_used_run(case, monkeypatch):
    monkeypatch.setattr(stretches, "Graphed", CpuReplay)
    tally = types.SimpleNamespace(graph_captures=0, graph_replays=0)
    budget = stretches._MEMORY_SHARE * CpuReplay.device_memory(None)
    plans = stretches.Plans(tally, limit=2 if case == "count" else None)
    if case == "off":
        plans.graphs = False
        run = _plan(plans, 1)
        assert type(run) is stretches.Eager and len(plans) == 0
        return
    if case == "single":
        a = _plan(plans, 1)
        a.nbytes = 2 * budget
        assert _plan(plans, 1) is a and list(plans.values()) == [a]
        b = _plan(plans, 2)
        b.nbytes = 2 * budget
        assert _plan(plans, 2) is b and list(plans.values()) == [b]
        return
    a, b = _plan(plans, 1), _plan(plans, 2)
    assert isinstance(a, CpuReplay) and a is not b
    assert _plan(plans, 1) is a  # a is now the most recently used
    if case == "memory":
        a.nbytes = b.nbytes = budget / 2  # at the budget, not over it
        c = _plan(plans, 3)
        assert list(plans.values()) == [b, a, c]
        c.nbytes = 1
        assert _plan(plans, 1) is a  # over the budget: b, the oldest, goes
        assert list(plans.values()) == [c, a]
    else:
        c = _plan(plans, 3)
        assert list(plans.values()) == [a, c]
    key = next(reversed(plans))
    assert key[-1] == (("x", torch.float32, (3,) if case == "count" else (1,), (1,)),)
