"""The port imports neither JAX nor the JAX package.

Every module of ``sqpsolver_tpu_torch`` and ``chip_smoke.py`` is imported in
a fresh interpreter in which ``sys.modules["jax"]`` and
``sys.modules["sqpsolver_tpu"]`` are ``None``, so that any import of either
(direct or through another module) raises ``ImportError``.
"""

import os
import pkgutil
import subprocess
import sys

import sqpsolver_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["sqpsolver_tpu_torch"]
    for info in pkgutil.walk_packages(sqpsolver_tpu_torch.__path__, "sqpsolver_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_the_port_imports_no_jax():
    modules = _modules()
    assert {"sqpsolver_tpu_torch.algorithms.sqp_ls", "sqpsolver_tpu_torch.models.hs",
            "sqpsolver_tpu_torch.utils.checkpoint", "sqpsolver_tpu_torch.structure",
            "sqpsolver_tpu_torch.ops.kkt_bbd",
            "sqpsolver_tpu_torch.models.stochastic"} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sqpsolver_tpu'] = None\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print(len([m for m in sys.modules if m.startswith('sqpsolver_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= len(modules)
