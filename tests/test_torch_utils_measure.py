"""The measurement utilities (``utils/flops.py``, ``utils/profiling.py``) in
the port against the JAX package.

* Every analytic count function returns the JAX package's dict, value for
  value, on a grid of dense ``(n, m, s, ir_steps)`` and BBD dimensions, and
  ``total_flops`` on both backends and every shift.
* The peak table knows the two H100 parts by the names
  ``torch.cuda.get_device_name`` gives them and raises on another card.
* ``solve_timing`` returns the JAX package's three keys on a CPU toy solve;
  ``trace(device="cpu")`` writes a trace file.
"""

import itertools
import os

import pytest
import torch

import sqpsolver_tpu_torch as tp
from sqpsolver_tpu.utils import flops as j_flops
from sqpsolver_tpu_torch.models.toy import toy_nlp
from sqpsolver_tpu_torch.utils import flops, profiling


DENSE = list(itertools.product((2, 72, 344), (0, 1, 143, 609), (0, 96, 336), (0, 2, 4)))
#: (P, nd, ns, mr, n_schur): case118's structured blocks, the coupled case9
#: problem's, and small and degenerate ones
BBD = [(8, 96, 73, 112, 896), (10, 16, 21, 40, 160), (3, 8, 5, 8, 24), (1, 1, 0, 1, 8)]
SHIFTS = [("eigh", 0), ("power", 0), ("power", 12), ("gershgorin", 0), ("ladder", 0)]


@pytest.mark.parametrize("n,m,s,ir", DENSE[::3] + DENSE[1::7])
def test_dense_ipm_counts_match_jax(n, m, s, ir):
    assert flops.ipm_iter_flops_dense(n, m, s, ir) == j_flops.ipm_iter_flops_dense(n, m, s, ir)


@pytest.mark.parametrize("dims", BBD, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("ir", [0, 2, 4])
def test_bbd_ipm_counts_match_jax(dims, ir):
    assert flops.ipm_iter_flops_bbd(*dims, ir) == j_flops.ipm_iter_flops_bbd(*dims, ir)


@pytest.mark.parametrize("shift,iters", SHIFTS)
def test_sqp_and_total_counts_match_jax(shift, iters):
    for n in (2, 72, 344):
        assert flops.sqp_iter_flops(n, shift, iters) == j_flops.sqp_iter_flops(n, shift, iters)
    kw = dict(n=72, m=143, sqp_iters_total=220, qp_iters_total=2064, hessian_shift=shift,
              ir_steps=4, shift_iters=iters)
    for extra in ({}, {"schur_cap": 96}, {"bbd_dims": BBD[0]}):
        assert flops.total_flops(**kw, **extra) == j_flops.total_flops(**kw, **extra)


@pytest.mark.parametrize("name,fp32", [("NVIDIA H100 80GB HBM3", 67e12),
                                       ("NVIDIA H100 PCIe", 51e12)])
def test_peaks_of_the_two_h100_parts(name, fp32):
    peaks = flops.device_peaks(name)
    assert peaks["fp32"] == fp32 == peaks["fp64_tensor"]
    assert peaks["bf16"] > 10 * peaks["fp32"] and peaks["hbm"] >= 2.0e12


def test_peaks_raise_on_another_card():
    with pytest.raises(KeyError, match="no peak rates"):
        flops.device_peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError):
        flops.device_peaks("TPU v5 lite")


def test_solve_timing_keys_on_a_cpu_toy_solve():
    nlp = toy_nlp()
    solver = tp.make_batch_solver(nlp, tp.Parameters(max_iter=100, OutputFlag=0))
    data = tp.batch_data(nlp, 2, device="cpu")
    out = profiling.solve_timing(solver, data, repeats=2)
    assert set(out) == {"first_call_s", "steady_state_s", "compile_overhead_s"}
    assert out["first_call_s"] > 0 and out["steady_state_s"] > 0
    assert out["compile_overhead_s"] >= 0


def test_trace_on_the_cpu_writes_a_file(tmp_path):
    x = torch.arange(16.0).reshape(4, 4)
    with profiling.trace(str(tmp_path), device="cpu"):
        (x @ x).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1 and os.path.getsize(tmp_path / files[0]) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with profiling.trace(str(tmp_path)):
                pass
