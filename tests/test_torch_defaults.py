"""The port's entry points run on the card unless the caller asks for the CPU,
and the port reads its own copies of the MATPOWER case files.

* ``batch_data``, ``NLP.data``, ``nlp_data_to_torch`` and ``theta_to_torch``
  take ``device=None``, meaning the CUDA card.  Without a card they raise a
  ``RuntimeError`` that names ``device="cpu"`` and return nothing; with
  ``device="cpu"`` they give CPU tensors as before.  The single-NLP entry
  points ``optimize`` and ``presolve_start`` do the same.
* ``sqpsolver_tpu_torch/data/*.m`` is byte-identical to the JAX package's
  ``sqpsolver_tpu/models/data/*.m`` (read by path) but for one header comment,
  where the original names the reference checkout by an absolute path and the
  copy by ``reference/...``; ``load_case`` reads the port's copy.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu_torch.models import matpower
from sqpsolver_tpu_torch.models.toy import toy_nlp
from sqpsolver_tpu_torch.utils.warmstart import presolve_start

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DATA = os.path.join(REPO, "sqpsolver_tpu_torch", "data")
REFERENCE_DATA = os.path.join(REPO, "sqpsolver_tpu", "models", "data")

_ARRAYS = types.SimpleNamespace(
    x_l=np.zeros(2), x_u=np.ones(2), g_l=np.zeros(1), g_u=np.ones(1), x0=np.full(2, 0.5),
    theta={"pd": np.arange(3.0)},
)

ENTRY_POINTS = {
    "batch_data": lambda **kw: tp.batch_data(toy_nlp(), 2, **kw).x0,
    "NLP.data": lambda **kw: toy_nlp().data(**kw).x0,
    "nlp_data_to_torch": lambda **kw: tp.nlp_data_to_torch(_ARRAYS, **kw).theta["pd"],
    "theta_to_torch": lambda **kw: tp.theta_to_torch(_ARRAYS.theta, **kw)["pd"],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_the_card_unless_asked_for_the_cpu(name):
    call = ENTRY_POINTS[name]
    on_cpu = call(device="cpu")
    assert on_cpu.device.type == "cpu" and on_cpu.dtype == torch.float64
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default cannot fail here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


SOLVES = {
    "optimize": lambda **kw: tp.optimize(toy_nlp(), tp.Parameters(max_iter=2, OutputFlag=0), **kw).x,
    "presolve_start": lambda **kw: presolve_start(
        toy_nlp(), tp.Parameters(max_iter=2, OutputFlag=0), **kw
    ).x0[0].numpy(),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_single_nlp_solve_needs_the_card_unless_asked_for_the_cpu(name):
    call = SOLVES[name]
    assert call(device="cpu").shape == (2,)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default cannot fail here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


@pytest.mark.parametrize("name", ["case5", "case14", "case30", "case118"])
def test_case_file_is_the_ports_own_identical_copy(name, monkeypatch):
    with open(os.path.join(PORT_DATA, f"{name}.m"), "rb") as fh:
        own = fh.read()
    with open(os.path.join(REFERENCE_DATA, f"{name}.m"), "rb") as fh:
        original = fh.read()
    relative, n_paths = re.subn(rb"/\S*?/reference/", b"reference/", original)
    assert n_paths == 1 and own == relative
    assert os.path.samefile(matpower.DATA_DIR, PORT_DATA)
    seen = []
    parse = matpower.parse_matpower
    monkeypatch.setattr(
        matpower, "parse_matpower", lambda path, **kw: seen.append(path) or parse(path, **kw)
    )
    case = matpower.load_case(name)
    assert case.name == name
    assert [os.path.dirname(os.path.abspath(p)) for p in seen] == [PORT_DATA]
