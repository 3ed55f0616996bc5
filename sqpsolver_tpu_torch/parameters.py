"""Solver configuration.

Mirrors the reference's flat ``Parameters`` kwdef struct
(SqpSolver.jl ``src/parameters.jl:1-39``): same knob names and defaults so a
user of the reference can carry their configuration over.  On top of that it
adds the TPU-native knobs (QP interior-point controls, dtype/precision policy)
that have no counterpart in the reference because the reference delegates the
QP subproblem to an external solver (``src/parameters.jl:6-7``).

The dataclass is frozen and hashable; it holds the same fields and defaults as
the JAX package's ``Parameters``, so one value configures both packages.  In
this PyTorch port ``kkt_backend="pallas"`` selects the package's own
hand-written factorization kernel (``ops/chol_blocked.py``), and "xla"
selects ``torch.linalg.cholesky_ex``.  String get/set helpers mirror ``get_parameter``/``set_parameter``
(``src/parameters.jl:32-39``).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Algorithmic parameters (reference: src/parameters.jl)."""

    # --- reference-parity knobs (names and defaults from src/parameters.jl) ---
    mode: str = "Normal"
    algorithm: str = "SQP-TR"  # "SQP-TR" (trust region) or "SQP-LS" (line search)
    # hessian handling: "exact" (AD Lagrangian Hessian) or "none" (LP subproblems,
    # i.e. SLP mode; reference forces "none" when no Hessian callback exists,
    # src/MOI_wrapper.jl:1184-1188).
    # DELIBERATE DEVIATION (PARITY.md #10): the reference's kwdef default is
    # "none" (src/parameters.jl:10) but every real entry path overrides it —
    # MOI always passes an exact-Hessian evaluator when one exists — so the
    # effective reference behavior is exact-Hessian SQP; here that is the
    # default outright (AD always provides the Hessian).
    hessian_type: str = "exact"

    OutputFlag: int = 1
    StatisticsFlag: int = 0

    tol_direction: float = 1.0e-8
    tol_residual: float = 1.0e-8
    tol_infeas: float = 1.0e-8
    max_iter: int = 3000
    time_limit: float = float("inf")  # unimplemented in reference too (parameters.jl:21)
    init_mu: float = 1.0e0
    max_mu: float = 1.0e10
    rho: float = 0.8
    eta: float = 0.4
    tau: float = 0.9
    min_alpha: float = 1.0e-6
    tr_size: float = 10.0
    use_soc: bool = False

    # --- TPU-native knobs (no reference counterpart; replaces the external
    # Ipopt "external_optimizer" of src/parameters.jl:6-7) ---
    #: maximum interior-point iterations per QP subproblem solve
    qp_max_iter: int = 50
    #: convergence tolerance of the QP interior-point solver
    qp_tol: float = 1.0e-10
    #: elastic weight used to emulate hard constraints (rows whose slack is not
    #: freed); large values pin the elastic slacks to ~mu/w.
    elastic_weight: float = 1.0e8
    #: slack mass above which the (hard-constrained) QP is declared infeasible,
    #: triggering feasibility restoration (reference triggers on the external
    #: solver reporting INFEASIBLE, sqp_trust_region.jl:151)
    qp_infeas_tol: float = 1.0e-6
    #: fraction-to-boundary factor of the interior-point solver
    qp_ftb: float = 0.995
    #: warm-start each QP subproblem's interior-point solve from the previous
    #: SQP iteration's multipliers (and, after rejected steps, its primal
    #: step).  Cuts the Mehrotra iteration count roughly in half across an
    #: SQP sequence; under vmap the batched inner loop runs max-over-lanes
    #: trips, so the saving compounds.  The SOC correction QP additionally
    #: warm-starts from the QP it corrects.  Cold starts everywhere when off.
    qp_warm_start: bool = True
    #: inexact-SQP forcing sequence: each QP subproblem is solved to
    #: max(qp_tol, this factor * current outer KKT error, capped at 1e-3)
    #: instead of the full tolerance — iterations far from a KKT point get
    #: cheap loose QPs, the tolerance tightens automatically as the outer
    #: error shrinks.  0 (default) disables: loose QPs measurably degrade
    #: the LS driver (multipliers replaced outright from loose duals) and
    #: SLP/maximize modes (LP steps need boundary accuracy), and buy only
    #: ~8-12% fewer IPM iterations on the exact-Hessian ACOPF battery once
    #: warm starts are on.  Opt in (e.g. 0.05) for TR+exact-Hessian
    #: throughput runs.
    qp_tol_adaptive: float = 0.0
    #: compute dtype: "float64" or "float32"
    dtype: str = "float64"
    #: KKT linear-solve policy: "direct" (Cholesky in compute dtype),
    #: "mixed_ir" (float32 factorizations, per-solve refinement in the
    #: compute dtype — the measured-fastest TPU mode; QP tolerance floors
    #: at ~2e-6 because cond(K) ~ 1/mu outruns 1/eps_f32 on the barrier
    #: path), "mixed_polish" (mixed_ir to the floor, then the interior-point
    #: loop CONTINUES with direct float64 factorizations to the strict
    #: tolerance — reference-default 1e-8 regimes at near-mixed_ir cost,
    #: only the last ~2-4 iterations pay f64 emulation), or "mixed_plane"
    #: (every matmul/factorization in float32, block-level refinement;
    #: experimental — currently slower due to the 6-pass true-f32 matmul)
    kkt_precision: str = "direct"
    #: number of iterative-refinement sweeps for the mixed modes
    kkt_ir_steps: int = 2
    #: f64 stall-rescue phase for f32-factorized dense modes: a lane whose
    #: f32 IPM phase exits unconverged continues with exact factors instead
    #: of failing (zero trips on the happy path).  Off = one fewer traced
    #: IPM loop in the compiled program (smaller/faster compile), at the
    #: cost of losing the rescue for barrier-hard lanes.
    qp_rescue: bool = True
    #: KKT factorization backend: "xla" (jnp.linalg.cholesky) or "pallas"
    #: (blocked Pallas+MXU factorization, ops/chol_blocked.py)
    kkt_backend: str = "xla"
    #: solve the initial linear-feasibility projection QP
    #: (sqp_trust_region.jl:111-122).  "auto": compiled in whenever linear
    #: rows exist (selected at runtime by the violation test, like the
    #: reference); "off": skip entirely — saves one QP instantiation of
    #: compile time when the start point is known linear-feasible
    init_projection: str = "auto"
    #: use the block-structured (bordered-block-diagonal) KKT path: the
    #: condensed KKT matrix is never formed densely; interiors factor as
    #: batched dense Cholesky blocks + one dense separator Schur complement
    #: (ops/kkt_bbd.py).  Requires ``nlp.structure``.  This is the TPU-native
    #: stand-in for the reference's sparse ma57 factorization at case300+
    #: scale (examples/acopf/opf.jl:59-64).
    kkt_structured: bool = False
    #: number of interior blocks for the structured path (0 = auto: ~128
    #: variables per block)
    kkt_parts: int = 0
    #: cap on the QP Schur (stiff) set size for the dense mixed-precision
    #: path (ops/qp_ipm.py IpmOptions.schur_cap).  The hybrid IPM solves
    #: every small-E row (equalities + active constraints) through a dense
    #: Schur complement S; uncapped, S is (m, m) even though typically only
    #: equalities + a few active rows are stiff — at ACOPF scale the (m, m)
    #: factorization dominates the whole solve.  -1 = auto (equality count +
    #: headroom, enabled when it shrinks S meaningfully; f32-factorized
    #: dense paths only), 0 = never cap, >0 = explicit cap.  Overflow rows
    #: fold into K with a bounded 1/E (IpmOptions.invE_floor), exactly the
    #: structured (BBD) backend's bounded-condensation rule.
    schur_cap: int = -1
    #: indefinite-Hessian convexification bound: "eigh" (exact smallest
    #: eigenvalue; compiles a large QR-iteration program), "power" (shifted
    #: power iteration, ~40 matvecs, near-exact — the TPU-friendly choice),
    #: "gershgorin" (one-pass circle bound; very conservative), or "ladder"
    #: (NO global shift — only the f32-factorability floor; the KKT
    #: factorization's escalating-delta ladder regularizes per IPM
    #: iteration, the inertia-correction strategy of the reference's Ipopt
    #: backend.  A global -lambda_min shift can exceed the local curvature
    #: scale near ACOPF optima and damp every late step: case118 cold start
    #: measured 67 SQP iterations under "eigh" vs geometric-rate analysis
    #: pointing at the ~9x over-shift; see sqp_tr._convexify_impl)
    hessian_shift: str = "eigh"
    #: Lanczos steps for the matvec-only lambda_min bound ("power" mode and
    #: the structured path).  0 = auto: min(n, 64).  A loose bound
    #: over-shifts the convexification, and since pred/ared ratios use the
    #: ORIGINAL Hessian (sqp_trust_region.jl:487), over-shifted steps fail
    #: the ratio test — measured on structured case30 b8: 40 steps -> 18.9
    #: mean SQP iters, 72 (= n, exact) -> 15.75.
    hessian_shift_iters: int = 0

    def replace(self, **kw: Any) -> "Parameters":
        return dataclasses.replace(self, **kw)


def get_parameter(params: Parameters, pname: str) -> Any:
    """String-keyed read, mirroring reference get_parameter (parameters.jl:32)."""
    return getattr(params, pname)


def set_parameter(params: Parameters, pname: str, val: Any) -> Parameters:
    """String-keyed functional update, mirroring set_parameter (parameters.jl:36).

    The reference mutates in place; our Parameters is frozen,
    so this returns a new instance.
    """
    if not hasattr(params, pname):
        raise KeyError(f"unknown parameter: {pname!r}")
    return params.replace(**{pname: val})
