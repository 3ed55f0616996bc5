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

from .._lanes import amax0, amin_inf, mv, select, true_float32_matmul
from .chol_blocked import cholesky_blocked, tri_inv_blocked
from .stretches import Eager

#: multiplicative ladder for the inertia-correction regularization, and the
#: log-bisection steps that tighten an escalated rung
_REG_GROWTH = 100.0
_REG_MAX_TRIES = 10
_REG_BISECTIONS = 4


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


class LadderSpec(NamedTuple):
    """How the ladder factors one matrix (the options of :func:`factorize_spd`;
    ``factor_dtype`` resolved).  Its methods are the steps that
    :func:`run_ladder` asks of a ladder (``kkt_bbd.bbd_factorize`` has its
    own): the factorization call, the first rung's floor, a rung's factor
    input, the probe of a factor and the per-lane pick of one."""

    factor_dtype: torch.dtype
    backend: str = "xla"
    min_pivot: float = 0.0
    equilibrate: bool = False
    invert: bool = False

    def chol(self):
        """The factorization call: the hand kernel for float32 factors under
        ``"pallas"``, else the library."""
        if self.backend == "pallas" and self.factor_dtype == torch.float32:
            return cholesky_blocked
        return _chol_library

    def _eff(self, t: str, s: dict) -> torch.Tensor:
        return s[t + "Meff"] if self.equilibrate else s[t + "M"]

    def floor(self, t: str, s: dict) -> torch.Tensor:
        """The first rung: ``1e-12`` times the largest diagonal entry of the
        (equilibrated) matrix, at least 1."""
        diag = torch.diagonal(self._eff(t, s), dim1=-2, dim2=-1)
        return torch.clamp_min(amax0(torch.abs(diag)), 1.0) * 1e-12

    def shifted(self, t: str, s: dict, delta: torch.Tensor) -> torch.Tensor:
        """A rung's factor input: the (equilibrated) matrix plus ``delta I``,
        in the factor dtype."""
        M_eff = self._eff(t, s)
        eye = torch.eye(M_eff.shape[-1], dtype=M_eff.dtype, device=M_eff.device)
        return (M_eff + delta[:, None, None] * eye).to(self.factor_dtype)

    def probe(self, L: torch.Tensor) -> torch.Tensor:
        """Lanes whose factor is usable: finite, and past ``min_pivot``."""
        ok = _chol_ok(L)
        if self.min_pivot > 0.0:
            piv = amin_inf(torch.diagonal(L, dim1=-2, dim2=-1))
            ok = ok & (piv > self.min_pivot)
        return ok

    #: per lane, ``a`` where ``mask`` is set, else ``b``
    select = staticmethod(select)


# The ladder as stretches (``ops/stretches.py``) over slots named ``t + key``:
# ``M`` the matrix, ``Meff`` its equilibrated form (when equilibrated),
# ``dvec``/``scale`` the equilibration, ``floor`` the first rung, ``delta``,
# ``L``, ``ok``, ``tries`` the ladder's state, ``X`` the next factorization's
# input and ``Lraw`` its factor, ``nd`` the next rung, ``go`` the lanes that
# take it, ``lo``/``hi``/``L_hi``/``mid``/``esc`` the bisection, and
# ``matrix``/``Li`` the finished factorization's regularized matrix and
# inverse factor.  ``spec`` supplies the steps that depend on what is
# factored (:class:`LadderSpec`).


def _next_rung(spec, t, s, delta, ok, tries) -> dict:
    """The lanes that escalate next, and the next rung's input (made whether
    or not any lane takes it)."""
    new_delta = torch.where(delta == 0.0, s[t + "floor"], delta * _REG_GROWTH)
    return {
        t + "delta": delta, t + "ok": ok, t + "tries": tries,
        t + "go": ~ok & (tries < _REG_MAX_TRIES),
        t + "nd": new_delta, t + "X": spec.shifted(t, s, new_delta),
    }


def ladder_start(spec: LadderSpec, t: str, M: torch.Tensor, delta0) -> dict:
    """Stretch: the ladder's set-up for ``M`` (B, n, n) from ``delta0`` (a
    scalar or (B,)), and the first factorization's input."""
    B, dtype, dev = M.shape[0], M.dtype, M.device
    out = {t + "M": M}
    if spec.equilibrate:
        dvec = torch.clamp_min(torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)), 1e-30)
        scale = torch.rsqrt(dvec)
        out[t + "dvec"], out[t + "scale"] = dvec, scale
        out[t + "Meff"] = M * scale[:, :, None] * scale[:, None, :]
    if torch.is_tensor(delta0):
        delta = delta0.to(dtype).expand(B)
    else:
        delta = torch.full((B,), float(delta0), dtype=dtype, device=dev)
    out[t + "floor"] = spec.floor(t, out)
    out[t + "delta"] = delta
    out[t + "X"] = spec.shifted(t, out, delta)
    return out


def ladder_first(spec: LadderSpec, t: str, s: dict) -> dict:
    """Stretch after the first factorization."""
    L, delta = s[t + "Lraw"], s[t + "delta"]
    tries = torch.zeros(delta.shape[0], dtype=torch.int32, device=delta.device)
    return {t + "L": L, **_next_rung(spec, t, s, delta, spec.probe(L), tries)}


def ladder_rung(spec: LadderSpec, t: str, s: dict) -> dict:
    """Stretch after a factorization one rung up, on the lanes ``go``."""
    go, L_n = s[t + "go"], s[t + "Lraw"]
    delta = torch.where(go, s[t + "nd"], s[t + "delta"])
    ok = torch.where(go, spec.probe(L_n), s[t + "ok"])
    tries = s[t + "tries"] + go.to(torch.int32)
    return {t + "L": spec.select(go, L_n, s[t + "L"]), **_next_rung(spec, t, s, delta, ok, tries)}


def ladder_bisect_start(spec: LadderSpec, t: str, s: dict) -> dict:
    """Stretch: the bisection of the escalated ``delta`` in
    ``[delta / 100, delta]``, and its first probe's input."""
    delta = s[t + "delta"]
    lo = torch.maximum(delta / _REG_GROWTH, s[t + "floor"] * 1e-2)
    mid = torch.sqrt(lo * delta)
    return {
        t + "esc": s[t + "ok"] & (s[t + "tries"] > 0),
        t + "lo": lo, t + "hi": delta, t + "L_hi": s[t + "L"], t + "mid": mid,
        t + "X": spec.shifted(t, s, mid),
    }


def ladder_bisect(spec: LadderSpec, t: str, s: dict, last: bool) -> dict:
    """Stretch after a bisection probe: the next probe's input, or after the
    ``last`` the escalated lanes' ``delta`` and factor."""
    ok_m, mid = spec.probe(s[t + "Lraw"]), s[t + "mid"]
    lo = torch.where(ok_m, s[t + "lo"], mid)
    hi = torch.where(ok_m, mid, s[t + "hi"])
    L_hi = spec.select(ok_m, s[t + "Lraw"], s[t + "L_hi"])
    if last:
        esc = s[t + "esc"]
        return {
            t + "delta": torch.where(esc, hi, s[t + "delta"]),
            t + "L": spec.select(esc, L_hi, s[t + "L"]),
        }
    mid = torch.sqrt(lo * hi)
    return {
        t + "lo": lo, t + "hi": hi, t + "L_hi": L_hi, t + "mid": mid,
        t + "X": spec.shifted(t, s, mid),
    }


def run_ladder(run, spec: LadderSpec, t: str, *, true_f32: bool = False) -> None:
    """The ladder's host points on ``run`` (``ops/stretches.py``), from the
    slots ``floor``, ``delta`` and ``X`` (:func:`ladder_start`'s for one
    matrix) to the final ``L``, ``delta`` and ``ok``, with the steps of
    ``spec`` (a :class:`LadderSpec`, or another ladder's steps): a
    factorization, then one sync per rung (the lanes that escalate take the
    next rung, at most ``_REG_MAX_TRIES``); when any lane escalated,
    ``_REG_BISECTIONS`` bisection probes.  ``true_f32`` runs it all with
    TF32 off."""
    if true_f32:
        with true_float32_matmul():
            return run_ladder(run, spec, t)
    chol = spec.chol()
    run.factor(chol, t + "X", t + "Lraw")
    run.stretch(t + "first", lambda s: ladder_first(spec, t, s))
    escalated = False
    while run.sync(t + "go"):
        escalated = True
        run.factor(chol, t + "X", t + "Lraw")
        run.stretch(t + "rung", lambda s: ladder_rung(spec, t, s))
    if escalated:
        # the x100 ladder overshoots the minimal correction by up to 100x;
        # four log-bisection steps tighten [delta / 100, delta].  Lanes that
        # did not escalate keep their factor (under vmap the JAX cond is a
        # per-lane select)
        run.stretch(t + "bisect0", lambda s: ladder_bisect_start(spec, t, s))
        for i in range(_REG_BISECTIONS):
            run.factor(chol, t + "X", t + "Lraw")
            if i < _REG_BISECTIONS - 1:
                run.stretch(t + "bisect", lambda s: ladder_bisect(spec, t, s, False))
            else:
                run.stretch(t + "bisect_last", lambda s: ladder_bisect(spec, t, s, True))


def ladder_finish(spec: LadderSpec, t: str, s: dict) -> dict:
    """Stretch: the regularized matrix of the final ``delta`` and, under
    ``invert``, the explicit inverse factor."""
    M, delta = s[t + "M"], s[t + "delta"]
    if spec.equilibrate:
        reg_diag = torch.diag_embed(s[t + "dvec"])
    else:
        reg_diag = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    out = {t + "matrix": M + delta[:, None, None] * reg_diag}
    if spec.invert:
        out[t + "Li"] = tri_inv(s[t + "L"])
    return out


def ladder_factorization(spec: LadderSpec, t: str, s: dict) -> "Factorization":
    """The finished factorization held in the slots."""
    return Factorization(
        chol=s[t + "L"],
        matrix=s[t + "matrix"],
        delta=s[t + "delta"],
        ok=s[t + "ok"],
        scale=s[t + "scale"] if spec.equilibrate else None,
        inv_chol=s[t + "Li"] if spec.invert else None,
    )


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
    explicit inverse factor so back-solves become matvecs.  The stretches
    above, run as plain calls.
    """
    spec = LadderSpec(factor_dtype or M.dtype, backend, min_pivot, equilibrate, invert)
    run = Eager()
    run.stretch("start", lambda s: ladder_start(spec, "", M, delta0))
    run_ladder(run, spec, "")
    run.stretch("finish", lambda s: ladder_finish(spec, "", s))
    return ladder_factorization(spec, "", run.slots)


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
