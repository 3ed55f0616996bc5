"""The benchmark's fixed arithmetic: the card's peak rates, the least time a
``chol_tile`` launch could take, the analytic operation count of a dense
solve, and the grouping of device kernels by family.  Frozen copies, so
that a change to the program cannot move the yardstick it is measured by.
"""

from __future__ import annotations

#: per card, FLOP/s and bytes/s: NVIDIA H100 data sheet, dense rates.
#: Frozen copy of ``PEAKS`` in sqpsolver_tpu_torch/utils/flops.py.
PEAKS = {
    # H100 SXM5: FP32 67 TFLOPS, FP64 Tensor Core 67 TFLOPS, BF16 Tensor
    # Core 989 TFLOPS dense, HBM3 3.35 TB/s
    "NVIDIA H100 80GB HBM3": dict(fp32=67e12, fp64_tensor=67e12, bf16=989e12, hbm=3.35e12),
    # H100 PCIe: FP32 51 TFLOPS, FP64 Tensor Core 51 TFLOPS, BF16 Tensor
    # Core 756 TFLOPS dense, HBM2e 2.0 TB/s
    "NVIDIA H100 PCIe": dict(fp32=51e12, fp64_tensor=51e12, bf16=756e12, hbm=2.0e12),
}


def peaks(kind: str) -> dict:
    """The peak rates of the card named ``kind``
    (``torch.cuda.get_device_name``); a card not in the table raises."""
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for {kind!r}; known: {sorted(PEAKS)}")
    return PEAKS[kind]


def chol_bound_s(batch: int, n: int, kind: str) -> float:
    """Least seconds the card could take to factor (batch, n, n) float32
    tiles: every input byte read once and every output byte written once
    over the memory rate, against batch * n^3 / 3 operations over the
    float32 rate.  Frozen copy of ``chol_bound`` in chip_smoke.py."""
    pk = peaks(kind)
    return max(2 * batch * n * n * 4 / pk["hbm"], batch * n**3 / 3 / pk["fp32"])


def dense_solve_flops(*, n: int, m: int, schur_rows: int, ir_steps: int,
                      sqp_iterations: int, qp_iterations: int) -> float:
    """Useful FLOPs of a dense solve: per interior-point iteration the
    assembly, factorization, Schur and solve terms of ``ipm_iter_flops_dense``
    and per SQP iteration the ladder shift's 2 n^2 of ``sqp_iter_flops``
    (frozen copies from sqpsolver_tpu_torch/utils/flops.py), times the
    iterations summed over lanes."""
    s = schur_rows
    assemble = 2.0 * m * n * n
    factorize = (n**3) / 3.0 * 2.0
    schur = 2.0 * n * n * s + 2.0 * s * s * n + (s**3) / 3.0 * 2.0
    apply_f32 = 2.0 * n * n + 4.0 * n * s + 2.0 * s * s
    residual = 2.0 * n * n + 4.0 * n * m + 4.0 * n * s
    solve = 2.0 * ((ir_steps + 1) * apply_f32 + ir_steps * residual)
    return (assemble + factorize + schur + solve) * qp_iterations + 2.0 * n * n * sqp_iterations


def kernel_family(name: str) -> str:
    """Frozen copy of ``_kernel_family`` in chip_smoke.py."""
    low = name.lower()
    if "chol_tile" in low:
        return "chol_tile (hand kernel)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "gemm" in low or "gemv" in low or "dot_kernel" in low or "cutlass" in low:
        return "cuBLAS matmul"
    if "reduce" in low:
        return "reductions"
    if "sort" in low or "scatter" in low or "gather" in low or "index" in low:
        return "sort/gather/scatter"
    return "elementwise/other"
