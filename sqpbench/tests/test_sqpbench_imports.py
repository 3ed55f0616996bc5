"""Nothing the benchmark runs loads JAX or the JAX package: module names
are compared by their top-level part (before the first dot), whole, since
the port's name ``sqpsolver_tpu_torch`` begins with the JAX package's."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "sqpsolver_tpu"}

PROBE = r"""
import os, sys, json, glob
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from sqpbench.core import harness
for kind in ("entries", "metrics", "reference"):
    for path in sorted(glob.glob(os.path.join(harness.BENCH_DIR, kind, "*.py"))):
        if not path.endswith("__init__.py"):
            harness.load_module(path)
out = harness.run_cell("case30_dispatch", 2**31 + 5, 0.1, True, device="cpu",
                       overrides={{"traffic": {{"check_lanes": 1, "pool": None}}}})
import run
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(run.forbidden_modules()))
"""


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT)], cwd=os.path.join(ROOT, "sqpbench"),
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    tops = set(__import__("json").loads(lines[-2]))
    assert "sqpsolver_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert __import__("json").loads(lines[-1]) == []


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, os.path.join(ROOT, "sqpbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    names = ["sqpsolver_tpu_torch", "sqpsolver_tpu_torch.ops", "jaxfoo", "flaxen",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "sqpsolver_tpu.models"]
    assert run.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "sqpsolver_tpu.models"])


def test_no_source_of_the_benchmark_imports_them():
    for path in glob.glob(os.path.join(ROOT, "sqpbench", "**", "*.py"), recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
