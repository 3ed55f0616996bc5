"""The control of the comparison: the program's own float32 path
(``dtype="float32"``, the nearest precision below the float64 that both
configurations state) put in the place of the float64 solves has to come
out as not correct.

On the CPU at a size a test run can hold; on the card (marker ``gpu``) at
each cell's own size, on three seeds, with a short window of fresh
requests:

    python -m pytest -q -p no:randomly sqpbench/tests/test_sqpbench_control.py
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sqpbench.core import harness  # noqa: E402

CONTROL = {"dtype": "float32"}
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


def test_control_fails_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = harness.run_cell(
            "case30_b32", SEEDS[0], 0.1, False, device="cpu",
            overrides={"parameters": CONTROL,
                       "traffic": {"lanes": 4, "check_lanes": 4, "pool": None}})
    finally:
        torch.set_num_threads(n)
    assert out["correct"] is False, out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port on the card")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["case30_b32", "case30_dispatch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_on_the_card(card, workload, seed):
    # fresh requests for a short window: a pass of a pool under the float32
    # control, whose dispatch calls take 13-25 s, would take minutes
    out = harness.run_cell(workload, seed, 10.0, False, device=card,
                           overrides={"parameters": CONTROL, "traffic": {"pool": None}})
    print(workload, seed, {k: c["value"] for k, c in out["checks"].items()})
    assert out["correct"] is False, out["checks"]
