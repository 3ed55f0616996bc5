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
            "sqpsolver_tpu_torch.models.stochastic",
            "sqpsolver_tpu_torch.parallel.sharding", "sqpsolver_tpu_torch.parallel.multihost",
            "sqpsolver_tpu_torch.utils.flops",
            "sqpsolver_tpu_torch.utils.profiling"} <= set(modules)
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


def test_acopf_builders_load_no_jax():
    """Importing the port's ACOPF module and building (and evaluating) each
    of its four formulations, with the polar one on a case with PWL costs and
    a dcline, loads no JAX module."""
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sqpsolver_tpu'] = None\n"
        "import torch\n"
        "from sqpsolver_tpu_torch.models import acopf, matpower\n"
        "cases = [matpower.load_case('case9'), matpower.case9_variant(tempfile.mkdtemp(), 4, 'free')]\n"
        "nlps = [acopf.acopf_rect(cases[0]), acopf.acopf_ivr(cases[0]), acopf.acopf_wr(cases[0]),\n"
        "        acopf.acopf_polar(cases[0]), acopf.acopf_polar(cases[1])]\n"
        "for nlp in nlps:\n"
        "    data = nlp.data(device='cpu')\n"
        "    th = {k: v[None] for k, v in data.theta.items()}\n"
        "    nlp.obj_cons(data.x0[None], th)\n"
        "loaded = [m for m, mod in sys.modules.items() if mod is not None\n"
        "          and (m.split('.')[0] in ('jax', 'jaxlib') or m.startswith('sqpsolver_tpu.'))]\n"
        "print(len(nlps), loaded)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == "5 []", out.stdout
