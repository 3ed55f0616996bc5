"""Dense SPD solves with regularization and mixed-precision refinement
(torch port of the JAX package's ``ops/linsolve.py``), batch-first.

Every interior-point iteration factors condensed KKT matrices
``M + delta R`` and back-solves through them.  ``factorize_spd`` probes a
Cholesky factorization and escalates a primal regularization ``delta`` until
the factor is finite (and, for float32 factors, its smallest pivot clears
``min_pivot``), then bisects the escalated ``delta`` back down.  The JAX
package runs this ladder as a ``lax.while_loop`` under ``vmap``; here it is a
host loop over a per-lane mask (one host sync per trip), with every lane's
``delta`` exactly what the vmapped loop gives it.

Backends: ``"pallas"`` is the package's hand-written kernel
(:func:`ops.chol_blocked.cholesky_blocked`, float32 factors); ``"xla"`` is
``torch.linalg.cholesky_ex``, whose ``info`` failure signal is mapped to the
non-finite factor the JAX code tests for.  The kernel is float32 only, so a
factor asked for in another dtype (the direct float64 factors of the IPM's
phase 2) takes the library route under either backend.  The JAX package's
blocked route casts every matrix to float32 instead, which makes its
"float64" phase a second float32 one under ``kkt_backend="pallas"``; the
port does not copy that.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .._lanes import amax0, amin_inf, any_lane, mv, select
from .chol_blocked import cholesky_blocked, tri_inv_blocked

#: multiplicative ladder for the inertia-correction regularization
_REG_GROWTH = 100.0
_REG_MAX_TRIES = 10


class Factorization(NamedTuple):
    """Batched Cholesky factor bundle + metadata (leading axis = lanes)."""

    chol: torch.Tensor  # (B, n, n) lower factor, factor dtype
    matrix: torch.Tensor  # (B, n, n) regularized matrix, compute dtype
    delta: torch.Tensor  # (B,) regularization applied
    ok: torch.Tensor  # (B,) bool: the ladder found a factor
    scale: Optional[torch.Tensor] = None  # (B, n) Jacobi equilibration
    inv_chol: Optional[torch.Tensor] = None  # (B, n, n) explicit L^-1


def _chol_ok(L: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(L).all(dim=-1).all(dim=-1)


def _chol_library(A: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cholesky_ex`` of the symmetrized ``(A + A^T) / 2`` with
    its ``info`` failure mapped to a NaN factor: the JAX
    ``jnp.linalg.cholesky`` contract.  ``cholesky_ex`` reads the lower
    triangle only; the assembled Schur complement ``A K^-1 A^T`` is symmetric
    only to rounding, and a factor of its lower triangle misfits the matrix
    that the refinement sweep takes residuals against."""
    L, info = torch.linalg.cholesky_ex((A + A.transpose(-1, -2)) / 2)
    return torch.where((info == 0)[:, None, None], L, torch.nan)


def factorize_spd(
    M: torch.Tensor,
    delta0=0.0,
    *,
    factor_dtype=None,
    backend: str = "xla",
    min_pivot: float = 0.0,
    equilibrate: bool = False,
    invert: bool = False,
) -> Factorization:
    """Cholesky-factorize ``M + delta I`` (B, n, n) with escalating ``delta``.

    ``delta`` starts at ``delta0`` (a scalar or (B,)) and multiplies by 100
    until the factor is finite, at most 10 times; lanes that escalated then
    take 4 log-bisection steps in ``[delta / 100, delta]``.  ``equilibrate``
    factors the Jacobi-scaled ``d M d`` (unit diagonal, ``d = |diag M|^-1/2``)
    so ``delta`` acts relatively (``M + delta diag|M|``).  ``min_pivot > 0``
    also escalates while the smallest pivot is below it.  ``invert`` adds the
    explicit inverse factor so back-solves become matvecs.
    """
    B, n = M.shape[0], M.shape[-1]
    dtype = M.dtype
    fdtype = factor_dtype or dtype
    eye = torch.eye(n, dtype=dtype, device=M.device)

    scale = None
    reg_diag = eye
    if equilibrate:
        dvec = torch.clamp_min(torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)), 1e-30)
        scale = torch.rsqrt(dvec)
        M_eff = M * scale[:, :, None] * scale[:, None, :]
        reg_diag = torch.diag_embed(dvec)
    else:
        M_eff = M

    diag_scale = torch.clamp_min(
        amax0(torch.abs(torch.diagonal(M_eff, dim1=-2, dim2=-1))), 1.0
    )
    delta_floor = diag_scale * 1e-12
    delta0 = torch.as_tensor(delta0, dtype=dtype, device=M.device).expand(B)
    hand = backend == "pallas" and fdtype == torch.float32
    chol = cholesky_blocked if hand else _chol_library

    def attempt(delta):
        L = chol((M_eff + delta[:, None, None] * eye).to(fdtype))
        ok = _chol_ok(L)
        if min_pivot > 0.0:
            piv = amin_inf(torch.diagonal(L, dim1=-2, dim2=-1))
            ok = ok & (piv > min_pivot)
        return L, ok

    delta = delta0
    L, ok = attempt(delta)
    tries = torch.zeros(B, dtype=torch.int32, device=M.device)
    escalated_any = False
    while True:
        go = ~ok & (tries < _REG_MAX_TRIES)
        if not any_lane(go):
            break
        escalated_any = True
        new_delta = torch.where(delta == 0.0, delta_floor, delta * _REG_GROWTH)
        L_n, ok_n = attempt(new_delta)
        delta = torch.where(go, new_delta, delta)
        L = select(go, L_n, L)
        ok = torch.where(go, ok_n, ok)
        tries = tries + go.to(torch.int32)

    if escalated_any:
        # bisection of the escalated delta: the x100 ladder overshoots the
        # minimal correction by up to 100x; four log-bisection steps tighten
        # [delta / 100, delta].  Lanes that did not escalate keep their
        # factor (under vmap the JAX cond is a per-lane select).
        escalated = ok & (tries > 0)
        lo = torch.maximum(delta / _REG_GROWTH, delta_floor * 1e-2)
        hi, L_hi = delta, L
        for _ in range(4):
            mid = torch.sqrt(lo * hi)
            L_m, ok_m = attempt(mid)
            lo = torch.where(ok_m, lo, mid)
            hi = torch.where(ok_m, mid, hi)
            L_hi = select(ok_m, L_m, L_hi)
        delta = torch.where(escalated, hi, delta)
        L = select(escalated, L_hi, L)
    return Factorization(
        chol=L,
        matrix=M + delta[:, None, None] * reg_diag,
        delta=delta,
        ok=ok,
        scale=scale,
        inv_chol=tri_inv(L) if invert else None,
    )


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of batched lower-triangular factors by the
    product-doubling algorithm (matmuls only)."""
    if L.shape[-1] == 0:
        return L
    return tri_inv_blocked(L)


def cho_solve(L: torch.Tensor, b: torch.Tensor, *, vec: bool) -> torch.Tensor:
    """``(L L^T)^-1 b`` by a pair of triangular solves in the factor's dtype:
    ``b`` is a batch of vectors (B, n) when ``vec``, else of matrices
    (B, n, k)."""
    b = b.to(L.dtype)
    b2 = b.unsqueeze(-1) if vec else b
    y = torch.linalg.solve_triangular(L, b2, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x.squeeze(-1) if vec else x


def inv_chol_solve(Li: torch.Tensor, b: torch.Tensor, *, vec: bool) -> torch.Tensor:
    """``Li^T (Li b)`` in the inverse factor's dtype: :func:`cho_solve` through
    an explicit ``Li = L^-1``, as matrix products."""
    b = b.to(Li.dtype)
    if vec:
        return mv(Li.transpose(-1, -2), mv(Li, b))
    return torch.matmul(Li.transpose(-1, -2), torch.matmul(Li, b))


def _apply_inverse(fact: Factorization, b: torch.Tensor) -> torch.Tensor:
    """``(M + delta R)^-1 b`` through the factor, honoring the equilibration
    (``M^-1 b = d Ls^-T Ls^-1 (d b)``).  ``b`` is (B, n) or (B, n, k): the
    port's tensors always carry the batch axis, so two axes are vectors."""
    vec = b.dim() == 2
    if fact.inv_chol is not None:

        def core(v):
            return inv_chol_solve(fact.inv_chol, v, vec=vec)

    else:

        def core(v):
            return cho_solve(fact.chol, v, vec=vec)

    if fact.scale is None:
        return core(b)
    d = fact.scale if vec else fact.scale.unsqueeze(-1)
    return d * core(d * b)


def solve_factorized(fact: Factorization, b: torch.Tensor, ir_steps: int = 0):
    """Solve ``(M + delta R) x = b`` from a prepared factorization.  Factors
    in a narrower dtype, or explicit inverse factors, get ``max(ir_steps, 1)``
    refinement sweeps with residuals in the compute dtype."""
    dtype = fact.matrix.dtype
    x = _apply_inverse(fact, b).to(dtype)
    if fact.chol.dtype == dtype and ir_steps == 0 and fact.inv_chol is None:
        return x
    sweeps = (
        max(ir_steps, 1)
        if (fact.chol.dtype != dtype or fact.inv_chol is not None)
        else ir_steps
    )
    for _ in range(sweeps):
        if b.dim() == 2:
            r = b - mv(fact.matrix, x)
        else:
            r = b - torch.matmul(fact.matrix, x)
        x = x + _apply_inverse(fact, r).to(dtype)
    return x
