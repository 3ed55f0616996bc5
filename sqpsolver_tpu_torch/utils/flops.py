"""Analytic FLOP counts of a solve and the peak rates of the card (torch
port of the JAX package's ``utils/flops.py``).

The count functions are the JAX package's, term for term: dominant-term
FLOPs of one interior-point iteration (dense or BBD backend) and of one SQP
iteration, split by phase (assemble / factorize / schur / solve), so a
benchmark can report

    utilization = total_analytic_flops / wall_clock / peak.

Conventions
-----------
* A fused multiply-add counts as 2 FLOPs (matmul of (a,b)x(b,c) = 2abc).
* Cholesky of an (n,n) SPD matrix = n^3/3 FLOPs; triangular inverse
  (ops.linsolve.tri_inv) = n^3/3; triangular solve with k right-hand sides
  = n^2 k.
* Counts are *useful* algorithmic FLOPs -- regularization-ladder retries,
  masked lanes, and padding are intentionally NOT credited, so the reported
  utilization is conservative (the hardware does strictly more arithmetic).
* Evaluation-phase AD (coloring-compressed Jacobian/Hessian) is gather/
  scatter + small elementwise work: its FLOP count is negligible next to
  the cubic KKT terms and is reported as 0 here; its *time* is not
  negligible (it is latency-bound) -- that is exactly what a low
  utilization exposes.

Peak rates (:data:`PEAKS`, :func:`device_peaks`): NVIDIA's H100 data sheet,
dense rates without sparsity, by ``torch.cuda.get_device_name``.  The port
keeps float32 products at "highest" precision (no TF32) wherever factors
are formed, so its float32 work runs on the CUDA cores (``fp32``); float64
products may use the tensor cores (``fp64_tensor``); ``bf16`` is the
tensor cores' dense rate, the card's speed of light.  A card not in the
table raises: there is no default.
"""

from __future__ import annotations

#: per card, FLOP/s and bytes/s (NVIDIA H100 Tensor Core GPU data sheet)
PEAKS = {
    # H100 SXM5: FP32 67 TFLOPS, FP64 Tensor Core 67 TFLOPS, BF16 Tensor
    # Core 1,979 TFLOPS with sparsity (989 dense), HBM3 3.35 TB/s
    "NVIDIA H100 80GB HBM3": dict(fp32=67e12, fp64_tensor=67e12, bf16=989e12, hbm=3.35e12),
    # H100 PCIe: FP32 51 TFLOPS, FP64 Tensor Core 51 TFLOPS, BF16 Tensor
    # Core 1,513 TFLOPS with sparsity (756 dense), HBM2e 2.0 TB/s
    "NVIDIA H100 PCIe": dict(fp32=51e12, fp64_tensor=51e12, bf16=756e12, hbm=2.0e12),
}


def device_peaks(kind=None) -> dict:
    """The peak rates of a card: ``kind`` is its name as
    ``torch.cuda.get_device_name`` gives it, or None for the current card.
    Raises ``KeyError`` for a card not in :data:`PEAKS`."""
    if kind is None:
        import torch

        kind = torch.cuda.get_device_name()
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for {kind!r}; known: {sorted(PEAKS)}")
    return dict(PEAKS[kind])


def ipm_iter_flops_dense(n: int, m: int, s: int, ir_steps: int) -> dict:
    """Dominant-term FLOPs of ONE interior-point iteration, dense backend
    (ops/qp_ipm.py DenseOp) with a Schur (stiff) set of size ``s`` and
    ``ir_steps`` refinement sweeps per block solve.

    Phases: assemble (K = H + A' diag A), factorize (chol + tri_inv of K),
    schur (K^-1 A_s', S assembly + factorization), solve (2 Newton solves --
    predictor + corrector -- each with ir_steps+1 applications of the f32
    block solve plus compute-dtype residual matvecs)."""
    assemble = 2.0 * m * n * n
    factorize = (n**3) / 3.0 * 2.0  # chol + explicit inverse factor
    schur = 2.0 * n * n * s + 2.0 * s * s * n + (s**3) / 3.0 * 2.0
    # one block application: K^-1 r (2n^2, via inverse factors), A_s t (2ns),
    # S^-1 b (2s^2), dp correction K^-1A_s' dy (2ns); residual pass adds
    # K_mv (2n^2 + 4nm) + stiff matvecs (4ns)
    apply_f32 = 2.0 * n * n + 4.0 * n * s + 2.0 * s * s
    residual = 2.0 * n * n + 4.0 * n * m + 4.0 * n * s
    solve = 2.0 * ((ir_steps + 1) * apply_f32 + ir_steps * residual)
    return {
        "assemble": assemble,
        "factorize": factorize,
        "schur": schur,
        "solve": solve,
    }


def ipm_iter_flops_bbd(
    P: int, nd: int, ns: int, mr: int, n_schur: int, ir_steps: int
) -> dict:
    """Dominant-term FLOPs of ONE interior-point iteration through the
    structured bordered-block-diagonal backend (ops/kkt_bbd.py BbdOperator):
    P interior blocks of nd variables, separator of ns, mr rows per part,
    dense stiff Schur complement of n_schur = P * part_schur_cap rows
    (dynamic per-part stiff slots), ``ir_steps`` refinement sweeps per
    inner K/S application (dense-hybrid semantics)."""
    n = P * nd + ns
    # K blocks: K_pp einsum (P, mr, nd) x (P, mr, nd), K_ps, K_ss
    assemble = 2.0 * P * mr * nd * nd + 2.0 * P * mr * nd * ns \
        + 2.0 * P * mr * ns * ns
    # interiors: chol + tri_inv; panel W = L^-1 K_ps; separator Schur S and
    # its chol + tri_inv
    factorize = (
        2.0 * P * (nd**3) / 3.0
        + P * nd * nd * ns          # W panel solve
        + 2.0 * P * nd * ns * ns    # S = K_ss - W'W
        + 2.0 * (ns**3) / 3.0
    )
    # one raw f32 K application through the explicit inverse factors
    k_apply_rhs = 4.0 * P * nd * nd + 4.0 * P * nd * ns + 2.0 * ns * ns
    # one exact K matvec (structured H blocks + two J passes) for residuals
    k_mv = (2.0 * P * nd * nd + 4.0 * P * nd * ns + 2.0 * ns * ns) \
        + 4.0 * P * mr * (nd + ns)
    # stiff Schur: refined panel KiA = (1+ir) raw applications on n_schur
    # RHS + ir panel residuals; S = At' KiA (2 n nst^2); chol of S
    schur = (
        (ir_steps + 1) * n_schur * k_apply_rhs
        + ir_steps * n_schur * k_mv
        + 2.0 * n * n_schur * n_schur
        + (n_schur**3) / 3.0
    )
    # Newton solves: 2 per iteration, each = refined K solve + At
    # contraction (2 n nst) + refined S solve + dp correction (2 n nst)
    apply_once = (
        (ir_steps + 1) * k_apply_rhs + ir_steps * k_mv
        + (2 * ir_steps + 1) * 2.0 * n_schur * n_schur
        + 4.0 * n * n_schur
    )
    solve = 2.0 * apply_once
    return {
        "assemble": assemble,
        "factorize": factorize,
        "schur": schur,
        "solve": solve,
    }


def sqp_iter_flops(n: int, hessian_shift: str, shift_iters: int = 0) -> dict:
    """Per-SQP-iteration FLOPs outside the QP: the convexification bound.
    eigh ~ 10 n^3 (QR iteration estimate); power = ``shift_iters`` Lanczos
    matvecs (0 = the SQP solver's auto min(n, 64)); gershgorin = one
    elementwise pass."""
    if hessian_shift == "eigh":
        shift = 10.0 * n**3
    elif hessian_shift == "power":
        shift = (shift_iters or min(n, 64)) * 2.0 * n * n
    else:
        shift = 2.0 * n * n
    return {"shift": shift, "eval": 0.0}


def total_flops(
    *,
    n: int,
    m: int,
    sqp_iters_total: int,
    qp_iters_total: int,
    hessian_shift: str,
    ir_steps: int,
    schur_cap: int = 0,
    bbd_dims: tuple | None = None,
    shift_iters: int = 0,
) -> dict:
    """Total analytic FLOPs of a batched solve, by phase.

    ``sqp_iters_total`` / ``qp_iters_total`` are summed over lanes (the
    per-lane counters the solver already carries).  ``schur_cap`` = 0 means
    the full (m, m) Schur set.  ``bbd_dims = (P, nd, ns, mr, n_schur)``
    selects the structured count (n_schur = P * part_schur_cap)."""
    s = schur_cap if schur_cap > 0 else m
    if bbd_dims is not None:
        per_ipm = ipm_iter_flops_bbd(*bbd_dims, ir_steps=ir_steps)
    else:
        per_ipm = ipm_iter_flops_dense(n, m, s, ir_steps)
    per_sqp = sqp_iter_flops(n, hessian_shift, shift_iters)
    out = {k: v * qp_iters_total for k, v in per_ipm.items()}
    for k, v in per_sqp.items():
        out[k] = out.get(k, 0.0) + v * sqp_iters_total
    out["total"] = sum(v for k, v in out.items())
    return out
