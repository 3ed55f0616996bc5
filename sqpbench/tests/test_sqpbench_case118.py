"""The ``case118_b16`` cell on the CPU: its frozen case file, the plain
reference on it, a whole run through the chunked solver at two lanes, and
the planted faults that the comparison has to catch.

A case118 request of two lanes takes two to four minutes on the CPU (the
float64 rescue fallback re-solves both lanes).  So every run here holds
one request in its window (a pool of one, a window of 0 s), and a wrapper
answers a request whose loads the module has solved before with that
answer.  The warm-up's base loads are solved first, by a test of their
own; the traced run then solves its window's request and replays its
warm-up and its traced stretch (which has nothing to read without a card),
and the planted faults replay every request.  Run the file in one
process, in its order:

    python -m pytest -q -p no:randomly sqpbench/tests/test_sqpbench_case118.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sqpbench.core import harness  # noqa: E402
from sqpbench.core.faults import FAULTS, Fault  # noqa: E402
from sqpbench.core.traffic import warm_up_loads  # noqa: E402

SEED = 2**31 + 977
CASE = os.path.join(harness.BENCH_DIR, "cases", "case118.m")
TINY = {"traffic": {"lanes": 2, "check_lanes": 2, "pool": {"seed": 0, "requests": 1}}}
METRICS = ("fallback_share.chunked", "fallback_round_ms.chunked",
           "fallback_lanes_per_request.chunked", "graph_hit_share.chunked")
#: the per-layer metrics of the scenario cells that read the CPU's run too
SCEN = ("ipm_trip_ms.scen", "host_syncs_per_request.scen")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


#: answers by the bytes of their loads, over the module's runs
_ANSWERS: dict = {}


class _Replay:
    """Wraps the entry: a request whose loads the module has solved before
    gets that answer again."""

    def __init__(self, entry):
        self.entry, self.nb, self.nlp = entry, entry.nb, entry.nlp

    def request(self, loads):
        key = loads.tobytes()
        if key not in _ANSWERS:
            _ANSWERS[key] = self.entry.request(loads)
        return _ANSWERS[key]


def _run(trace=False, **kw):
    return harness.run_cell("case118_b16", SEED, 0.0, trace, device="cpu", overrides=TINY, **kw)


def test_case_file_is_the_ports_own():
    with open(CASE, "rb") as a, open(
            os.path.join(ROOT, "sqpsolver_tpu_torch", "data", "case118.m"), "rb") as b:
        assert a.read() == b.read()


def test_reference_reaches_the_published_optimum():
    ref = harness.load_module(os.path.join(harness.BENCH_DIR, "reference", "acopf_polar.py"))
    net = ref.read_case(CASE)
    model = ref.Model(net)
    assert (net.n, net.m) == (harness.resolve("case118_b16").config["n"],
                              harness.resolve("case118_b16").config["m"])
    sol = ref.solve(model, np.concatenate([net.pd, net.qd])[None])
    assert sol.solved.all()
    assert abs(sol.obj[0] - 129660.70) / 129660.70 < 1e-5


def test_warm_up_reaches_the_published_optimum_through_the_fallback():
    cell = harness.resolve("case118_b16")
    net = harness.load_module(os.path.join(harness.BENCH_DIR, "reference", "acopf_polar.py")
                              ).read_case(CASE)
    entry = harness.load_module(os.path.join(harness.BENCH_DIR, "entries", "chunked_solver.py")
                                ).build(case_path=CASE, formulation=cell.config["formulation"],
                                        parameters=cell.config["parameters"], lanes=2,
                                        device=torch.device("cpu"))
    ans = _Replay(entry).request(warm_up_loads(net, TINY["traffic"]))
    assert (ans["status"] == 0).all()
    assert (abs(ans["obj"] - 129660.70) / 129660.70 < 1e-4).all(), ans["obj"]
    # both lanes stall in the float32 first pass; the float64 fallback solves them
    assert (ans["fallback_lanes"] == 2).all()
    assert (ans["chunked_rounds"] > ans["fallback_rounds"]).all()
    assert (ans["fallback_rounds"] > 0).all()
    assert (ans["first_pass_s"] > 0).all() and (ans["fallback_s"] > 0).all()


def test_cell_end_to_end_traced():
    out = _run(trace=True, wrap_entry=_Replay)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 2 and out["failed"] == 0
    assert out["device"]["busy_s"] == 0  # no card: no device operation
    assert set(out["checks"]) == set(harness.resolve("case118_b16").config["limits"]) | {"judged"}
    # the CPU runs no CUDA graph: the hit share has no base and stays out;
    # without a card's trace the roofline and the idle share stay out too
    assert set(out["metrics"]) == set(METRICS + SCEN) - {"graph_hit_share.chunked"}
    assert 0 < out["metrics"]["fallback_share.chunked"]["value"] <= 100
    assert out["metrics"]["fallback_round_ms.chunked"]["value"] > 0
    assert out["metrics"]["fallback_lanes_per_request.chunked"]["value"] in (1, 2)


def test_float32_reference_control_fails_a_limit():
    control = harness.load_module(os.path.join(harness.BENCH_DIR, "reference_control.py"))
    ref = harness.load_module(os.path.join(harness.BENCH_DIR, "reference", "acopf_polar.py"))
    net = ref.read_case(CASE)
    limits = harness.resolve("case118_b16").config["limits"]
    numbers = control.control_numbers(ref, net, warm_up_loads(net, TINY["traffic"]), 1e-5)
    assert numbers["judged"] == 2
    assert numbers["viol"] > limits["viol"], numbers


@pytest.mark.parametrize("how", FAULTS)
def test_planted_faults_make_the_run_incorrect(how):
    out = _run(wrap_entry=lambda e: Fault(_Replay(e), how))
    assert out["correct"] is False, (how, out["checks"])
