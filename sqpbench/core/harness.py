"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix, entry, metric
or reference lives in a file of its own under ``sqpbench/``, found by the
name that ``BENCHMARK.json`` or the configuration gives:

* ``configs/<config>.json``: case file, formulation, entry, reference,
  ``parameters`` of the solver, the limits of the comparison;
* ``traffic/<mix>.json``: lanes per request, load spread, the pool of
  requests, lanes checked;
* ``entries/<entry>.py``: ``build(case_path, formulation, parameters,
  lanes, device)`` returns an object whose ``request(loads)`` solves one
  request (``formulation`` names the model builder of
  ``sqpsolver_tpu_torch.models.acopf``);
* ``metrics/<metric>.py``: ``read(run)`` returns the metric's value from a
  :class:`Run`, or None when the run has nothing to read for it;
* ``reference/<reference>.py``: ``read_case``, ``Model``, ``solve`` and
  ``judge``, the plain reference of the formulation.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from . import program
from .trace import DeviceTrace
from .traffic import pool_size, request_loads, warm_up_loads

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds of whole requests the traced stretch holds at least
TRACE_SECONDS = 3.0
#: the stream index of the draw of lanes to check
CHECK_STREAM = 2**32 - 2


def load_module(path: str):
    """Import the file ``path`` as a module of its own (names may hold dots)."""
    name = "sqpbench._files." + os.path.relpath(path, BENCH_DIR).replace(os.sep, "_").replace(".", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list

    def path(self, *parts) -> str:
        return os.path.join(os.path.dirname(BENCH_DIR), *parts)


def resolve(workload: str, root: str | None = None) -> Cell:
    """The cell ``workload`` of the ``BENCHMARK.json`` at the root of the
    checkout: its configuration, its traffic mix, and the metrics it
    reports (an end-to-end metric without ``workloads`` is reported by
    every cell; a per-layer one without them by every cell that reports the
    end-to-end metric it moves)."""
    root = root or os.path.dirname(BENCH_DIR)
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = read_json(os.path.join(root, cfg["file"]))
    traffic = read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))

    def mine(metric, default):
        return workload in metric["workloads"] if "workloads" in metric else default

    e2e = [m for m in bench["end_to_end"] if mine(m, True)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if mine(m, m["moves"] in names)]
    return Cell(workload, config, traffic, int(w["chips"]), e2e, per_layer)


@dataclasses.dataclass
class Request:
    seconds: float
    loads: np.ndarray  # (lanes, 2 nb)
    answer: dict  # lanes first; tensors on the device until the window closes


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    device: torch.device
    device_kind: str
    setup_s: float
    window_s: float
    requests: list  # the window's, in order
    counters: dict  # the program's counters over the window
    trace: dict | None  # the traced stretch (``trace.reduce_events``) with
    # ``chol_shapes`` and ``requests``

    def solved(self, req: Request) -> int:
        return int(np.isin(req.answer["status"], (0, 1, 6)).sum())


def _host(answer: dict) -> dict:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in answer.items()}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, overrides: dict | None = None,
             wrap_entry=None, log=lambda msg: None) -> dict:
    """One run of the cell; returns the result line's object, the compared
    numbers under ``checks`` last.  ``overrides`` replaces entries of the
    configuration's ``parameters`` (key ``parameters``) and of the traffic
    mix (key ``traffic``); ``wrap_entry`` wraps the built entry (tests
    plant faults with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = resolve(workload)
    overrides = overrides or {}
    params = dict(cell.config["parameters"], **overrides.get("parameters", {}))
    traffic = dict(cell.traffic, **overrides.get("traffic", {}))
    case_path = cell.path(cell.config["case_file"])
    ref = load_module(os.path.join(BENCH_DIR, "reference", f"{cell.config['reference']}.py"))
    net = ref.read_case(case_path)
    entry_mod = load_module(os.path.join(BENCH_DIR, "entries", f"{cell.config['entry']}.py"))
    entry = entry_mod.build(case_path=case_path, formulation=cell.config["formulation"],
                            parameters=params, lanes=int(traffic["lanes"]), device=device)
    if wrap_entry is not None:
        entry = wrap_entry(entry)

    t_warm = time.perf_counter()
    log(f"set-up before the warm-up request {t_warm - t_start:.3f} s")
    entry.request(warm_up_loads(net, traffic))
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (warm-up request {time.perf_counter() - t_warm:.3f} s)")

    before = program.counters()
    requests, index, passes = [], 0, pool_size(traffic)
    t0 = time.perf_counter()
    while True:
        loads = request_loads(net, traffic, seed, index)
        ts = time.perf_counter()
        answer = entry.request(loads)
        _sync(device)
        te = time.perf_counter()
        requests.append(Request(te - ts, loads, answer))
        log(f"request {index}: {te - ts:.3f} s")
        index += 1
        # the request in flight finishes, and with a pool, the pass
        if te - t0 >= seconds and index % passes == 0:
            break
    window_s = te - t0
    counters = program.delta(before, program.counters())
    log(f"window {window_s:.3f} s, {len(requests)} requests; program counters {counters}")

    traced = None
    if trace:
        done = []
        with program.chol_tile_shapes() as shapes, DeviceTrace(device, log) as tr:
            ts0 = time.perf_counter()
            while not done or time.perf_counter() - ts0 < TRACE_SECONDS:
                loads = request_loads(net, traffic, seed, index)
                done.append(Request(0.0, loads, entry.request(loads)))
                index += 1
            _sync(device)
        traced = dict(tr.summary, chol_shapes=shapes, requests=done)
        log(f"traced {len(done)} requests over {traced['window_s']:.3f} s")

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    for req in requests + (traced["requests"] if traced else []):
        req.answer = _host(req.answer)
    del entry
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, on a sample of the lanes drawn from the seed
    pool = requests + (traced["requests"] if traced else [])
    pairs = [(i, j) for i, req in enumerate(pool) for j in range(req.loads.shape[0])]
    rng = np.random.default_rng([int(seed), CHECK_STREAM])
    take = min(int(traffic["check_lanes"]), len(pairs))
    pick = sorted(rng.choice(len(pairs), size=take, replace=False).tolist())
    loads = np.stack([pool[pairs[p][0]].loads[pairs[p][1]] for p in pick])
    answers = {
        k: np.stack([pool[pairs[p][0]].answer[k][pairs[p][1]] for p in pick]).astype(
            np.float64 if k not in ("status",) else np.int64)
        for k in ("x", "obj", "status", "mult_g", "mult_x_L", "mult_x_U")
    }
    t_ref = time.perf_counter()
    model = ref.Model(net)
    numbers = ref.judge(model, loads, answers, ref.solve(model, loads))
    log(f"reference: {take} lanes in {time.perf_counter() - t_ref:.3f} s; {numbers}")
    limits = cell.config["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = numbers["judged"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    checks["judged"] = {"value": numbers["judged"], "limit": 1, "at_least": True}

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(cell, device, kind, setup_s, window_s, requests, counters, traced)
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(os.path.join(BENCH_DIR, "metrics", f"{spec['name']}.py")).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    lanes = sum(r.loads.shape[0] for r in requests)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": lanes,
           "failed": lanes - sum(run.solved(r) for r in requests), "metrics": metrics,
           "device": dev}
    if traced:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        top = sorted(traced["device_ops"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k[:160], v] for k, v in top],
                            "idle_gaps": [[k[:160], v] for k, v in traced["idle_gaps"]]}
    out["checks"] = checks
    return out
