"""The benchmark harness on the CPU at a tiny size: a whole run of each
cell through the plain factorization, the result's keys, the reference
against the port, and planted faults that the comparison has to catch.

Run from the root of the repository:

    python -m pytest -q -p no:randomly sqpbench/tests
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sqpbench.core import harness  # noqa: E402
from sqpbench.core.faults import Fault  # noqa: E402
from sqpbench.core.traffic import pool_size, request_loads  # noqa: E402

SEED = 2**31 + 977  # above 32 signed bits: seeds of that size must work
POOL2 = {"seed": 0, "requests": 2}  # a pass of two requests
TINY = {"traffic": {"lanes": 2, "check_lanes": 4, "pool": POOL2}}
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, trace=False, overrides=TINY, **kw):
    return harness.run_cell(workload, SEED, 0.5, trace, device="cpu", overrides=overrides, **kw)


@pytest.mark.parametrize("pool", [POOL2, None], ids=["pool", "fresh"])
def test_batched_cell_end_to_end(pool):
    out = _run("case30_b32", overrides={"traffic": dict(TINY["traffic"], pool=pool)})
    assert list(out)[: len(RESULT_KEYS)] == list(RESULT_KEYS)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    if pool:  # the window runs whole passes of the pool
        assert out["attempted"] % (2 * pool["requests"]) == 0
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert set(out["checks"]) == {"unsolved", "viol", "kkt", "obj_gap", "judged"}


def test_dispatch_cell_traced_reports_its_per_layer_metrics():
    out = _run("case30_dispatch", trace=True,
               overrides={"traffic": {"check_lanes": 4, "pool": POOL2}})
    assert out["correct"] is True, out["checks"]
    # without a card the device metrics find nothing to read and stay out
    assert set(out["metrics"]) == {
        "sqp_iter_ms.dispatch", "ipm_trip_ms.dispatch", "host_syncs_per_request.dispatch"}
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_metric_lists_follow_the_benchmark_file():
    cell = harness.resolve("case30_b32")
    assert [m["name"] for m in cell.end_to_end] == ["solves_per_s", "setup_s"]
    assert "chol_tile_roofline.scen" in [m["name"] for m in cell.per_layer]
    assert all(m["name"].endswith(".scen") for m in cell.per_layer)
    disp = harness.resolve("case30_dispatch")
    assert [m["name"] for m in disp.end_to_end] == ["solve_s", "setup_s"]
    assert all(m["name"].endswith(".dispatch") for m in disp.per_layer)


def test_every_name_has_its_file():
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics", f"{m['name']}.py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    for c in bench["configs"]:
        cfg = harness.read_json(os.path.join(ROOT, c["file"]))
        for kind in ("entries", "reference"):
            key = "entry" if kind == "entries" else "reference"
            assert os.path.exists(os.path.join(harness.BENCH_DIR, kind, f"{cfg[key]}.py"))


def test_loads_follow_seed_and_index():
    ref = harness.load_module(os.path.join(harness.BENCH_DIR, "reference", "acopf_polar.py"))
    net = ref.read_case(os.path.join(harness.BENCH_DIR, "cases", "case30.m"))
    fresh = {"lanes": 3, "spread": 0.03}
    a = request_loads(net, fresh, SEED, 5)
    assert np.array_equal(a, request_loads(net, fresh, SEED, 5))
    assert not np.array_equal(a, request_loads(net, fresh, SEED, 6))
    assert not np.array_equal(a, request_loads(net, fresh, SEED + 1, 5))
    scale = a[:, :30].sum(1) / net.pd.sum()
    assert np.all(np.abs(scale - 1) <= 0.03 * 1.02)
    # a pool: every seed cycles through the same requests, in its own order
    pool = dict(fresh, pool={"seed": 0, "requests": 8})
    assert pool_size(pool) == 8 and pool_size(fresh) == 1

    def one_pass(seed, start=0):
        return [request_loads(net, pool, seed, i).tobytes() for i in range(start, start + 8)]

    first, other = one_pass(SEED), one_pass(SEED + 1)
    assert sorted(first) == sorted(other) and first != other
    assert len(set(first)) == 8
    assert one_pass(SEED, 8) == first
    # request i of a pool is drawn from the pool's seed and i, whichever the run's seed
    assert request_loads(net, fresh, 0, 5).tobytes() in first


def test_reference_agrees_with_the_port():
    """The port's float64 answers on case30 at batch 4 against the
    reference's solves: objectives within 1e-7, every lane solved."""
    import sqpsolver_tpu_torch as sqp
    from sqpsolver_tpu_torch.models.acopf import acopf_polar
    from sqpsolver_tpu_torch.models.matpower import parse_matpower

    ref = harness.load_module(os.path.join(harness.BENCH_DIR, "reference", "acopf_polar.py"))
    path = os.path.join(harness.BENCH_DIR, "cases", "case30.m")
    net = ref.read_case(path)
    loads = request_loads(net, {"lanes": 4, "spread": 0.03}, SEED, 0)
    cfg = harness.resolve("case30_b32").config
    nlp = acopf_polar(parse_matpower(path))
    out = sqp.make_batch_solver(nlp, sqp.Parameters(**cfg["parameters"]))(
        sqp.batch_data(nlp, 4, theta={"pd": loads[:, :30], "qd": loads[:, 30:]}, device="cpu"))
    sol = ref.solve(ref.Model(net), loads)
    assert sol.solved.all() and (out.status.numpy() == 0).all()
    assert np.abs(out.obj_val.numpy() - sol.obj).max() / sol.obj.min() < 1e-7
    # the model rows agree with the port's to rounding at the port's answer
    th = {"pd": torch.as_tensor(loads[0, :30]), "qd": torch.as_tensor(loads[0, 30:])}
    rows_port = nlp.g(out.x[0], th)
    rows_ref = ref.Model(net).rows(out.x[0], torch.as_tensor(loads[0]))
    assert (rows_port - rows_ref).abs().max() < 1e-12


@pytest.mark.parametrize("workload,how", [
    ("case30_b32", "unchanged"), ("case30_b32", "half"), ("case30_b32", "altered"),
    ("case30_dispatch", "unchanged"), ("case30_dispatch", "altered")])
def test_planted_faults_make_the_run_incorrect(workload, how):
    lanes = 2 if workload == "case30_b32" else 1
    out = _run(workload, overrides={"traffic": dict(TINY["traffic"], lanes=lanes)},
               wrap_entry=lambda e: Fault(e, how))
    assert out["correct"] is False, (how, out["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_planted_faults_at_the_cells_size_on_the_card(how):
    """b32 at its own 32 lanes, one fresh request (``readings.py --fault``
    reads them the same way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the port on the card")
    out = harness.run_cell("case30_b32", SEED, 0.1, False, device="cuda:0",
                           overrides={"traffic": {"pool": None}},
                           wrap_entry=lambda e: Fault(e, how))
    assert out["correct"] is False, (how, out["checks"])


def test_run_without_a_card_prints_nothing_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "sqpbench/run.py", "--workload", "case30_b32", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_checks_print_value_and_limit():
    out = _run("case30_b32")
    line = json.loads(json.dumps(out))
    for name, c in line["checks"].items():
        assert set(c) >= {"value", "limit"}, name
