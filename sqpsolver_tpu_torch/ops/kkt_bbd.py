"""Bordered-block-diagonal (BBD) KKT factorization and the structured IPM
operator (torch port of the JAX package's ``ops/kkt_bbd.py``), batch-first.

A vertex-separator partition of the variable-interaction graph
(:mod:`sqpsolver_tpu_torch.structure`) permutes the condensed matrix

    K = H + diag(ridge + Dp) + A' diag(invE) A

into arrow form::

    [ K_11          K_1s ]     P independent interior blocks (nd x nd)
    [      ...      ...  ]
    [          K_PP K_Ps ]
    [ K_s1 ... K_sP K_ss ]     dense separator block (ns x ns)

The factorization is a batched dense Cholesky of the interiors and a dense
Cholesky of the separator's Schur complement; every block tensor carries the
lanes on its leading axis (``K_pp`` (B, P, nd, nd), ``K_ps`` (B, P, nd, ns),
``K_ss`` (B, ns, ns)).  Stability comes from the dense path's escalating
regularization ladder (``linsolve.run_ladder``) with the BBD blocks' steps,
run eagerly; float64 refinement recovers the accuracy of float32 factors.

The interiors and the separator are factored by the library
(``torch.linalg.cholesky_ex``, as the JAX package factors them with
``jnp.linalg.cholesky``); the stiff Schur complement of the IPM goes through
:func:`ops.linsolve.factorize_spd`, so under ``kkt_backend="pallas"`` it is
the hand-written kernel's, one launch per 128-panel.

Every map between the global and the block layouts is a gather: each global
variable (row) has exactly one slot, so scattering the blocks back reads the
slot of each global index instead of writing every pad slot to one dummy
index.  Sums over parts are ``einsum`` products; nothing here adds with
atomics.

Block sharding of one instance (``BlockMaps(groups=part_groups(P,
devices))``, the JAX package's GSPMD part-axis sharding made explicit): the
P parts split into ``len(devices)`` contiguous groups by part index, group
``g`` on ``devices[g]`` (the partition may return more parts than
``kkt_parts`` asked for; the groups then differ by one part).  Each group's
interior factors and panel ``W = L_pp^-1 K_ps`` are formed and applied on
its device; each group's separator term ``W' W`` (and ``W' y`` in a solve)
is summed onto the lanes' device, the one cross-device reduction.  The
blocks are assembled, and the separator and the stiff Schur complement
factored, on the lanes' device.
"""

from __future__ import annotations

import dataclasses
import types
from functools import reduce
from typing import NamedTuple

import numpy as np
import torch

from .._lanes import amax0, amin_inf, select
from .linsolve import _chol_library, factorize_spd, run_ladder, solve_factorized, tri_inv
from .stretches import Eager

_BIG = 1e20  # stand-in for +inf inside masked arithmetic (qp_ipm._BIG)


class JacBlocks(NamedTuple):
    """Constraint Jacobian in block form: ``A_int`` (B, P, mr, nd) and
    ``A_sep`` (B, P, mr, ns), the rows of each part against its interior and
    the separator."""

    A_int: torch.Tensor
    A_sep: torch.Tensor


class HessBlocks(NamedTuple):
    """Lagrangian Hessian in block form: ``H_pp`` (B, P, nd, nd), ``H_ps``
    (B, P, nd, ns), ``H_ss`` (B, ns, ns)."""

    H_pp: torch.Tensor
    H_ps: torch.Tensor
    H_ss: torch.Tensor


class BbdFactor(NamedTuple):
    """A BBD factor; the interior pieces are tuples with one entry per part
    group, each on its group's device (one group unless block-sharded)."""

    Li_pp: tuple  # (B, P_g, nd, nd) explicit inverses of the interior factors
    W: tuple  # (B, P_g, nd, ns) L_pp^-1 K_ps
    Li_ss: torch.Tensor  # (B, ns, ns) inverse of the equilibrated Schur factor
    dS: torch.Tensor  # (B, ns) Jacobi scale of the separator Schur complement
    delta: torch.Tensor  # (B,) regularization applied
    ok: torch.Tensor  # (B,) bool
    groups: tuple  # ((device, part slice), ...)


def _diag(M):
    return torch.diagonal(M, dim1=-2, dim2=-1)


def _eye_add(M, d):
    """``M`` plus ``diag(d)`` on its last two axes (``d`` broadcasts)."""
    return M + torch.diag_embed(d.expand(M.shape[:-1]))


def _tri_inv_batched(L):
    lead, k = L.shape[:-2], L.shape[-1]
    return tri_inv(L.reshape((-1, k, k))).reshape(lead + (k, k))


def bbd_factorize(
    K_pp, K_ps, K_ss, delta0, min_pivot: float = 1e-3, groups=None
) -> BbdFactor:
    """Factor a batch of BBD matrices with the escalating-regularization
    ladder (``linsolve.run_ladder``, run eagerly): ``delta`` starts at
    ``delta0`` (B,) and multiplies by 100 until both factors are finite with
    pivots above ``min_pivot``, at most 10 times; lanes that escalated then
    take 4 log-bisection steps.  Each try costs one host sync; lanes that
    are done keep their factor bit for bit.

    Inputs are factor-dtype blocks (float32 normally, float64 in the rescue
    phase); padded interior slots carry an identity diagonal and zero
    couplings (:class:`BbdOperator` assembles them so).  ``groups``
    (``BlockMaps.groups``) factors each part group's interiors on its own
    device; every group's finite test and smallest pivot join the
    separator's on the lanes' device before the ladder decides."""
    B, P, nd, _ = K_pp.shape
    fdt = K_pp.dtype
    dev = K_pp.device
    groups = groups or ((dev, slice(None)),)
    parts = [(gdev, K_pp[:, sl].to(gdev), K_ps[:, sl].to(gdev)) for gdev, sl in groups]
    G = len(parts)
    diag_scale = torch.clamp_min(
        torch.maximum(
            amax0(torch.abs(_diag(K_pp)).reshape(B, P * nd)),
            amax0(torch.abs(_diag(K_ss))),
        ),
        1.0,
    )
    delta_floor = diag_scale * (1e-7 if fdt == torch.float32 else 1e-12)
    delta0 = torch.as_tensor(delta0, dtype=fdt, device=dev).expand(B)

    def attempt(delta):
        """A rung's factor: ``(*L_g, *W_g, L_ss, dS)``."""
        L_g, W_g, seps = [], [], []
        for gdev, Kpp, Kps in parts:
            Pg = Kpp.shape[1]
            L = _chol_library(
                _eye_add(Kpp, delta.to(gdev)[:, None, None]).reshape(B * Pg, nd, nd)
            ).reshape(B, Pg, nd, nd)
            W = torch.linalg.solve_triangular(L, Kps, upper=False)
            L_g.append(L)
            W_g.append(W)
            seps.append(torch.einsum("bpki,bpkj->bij", W, W).to(dev))
        S = _eye_add(K_ss, delta[:, None]) - reduce(torch.add, seps)
        # the Schur complement loses the caller's unit diagonal; its own
        # Jacobi scale keeps the float32 factor and the pivot probe meaningful
        dS = torch.rsqrt(torch.clamp_min(torch.abs(_diag(S)), 1e-30))
        L_ss = _chol_library(S * dS[:, :, None] * dS[:, None, :])
        return (*L_g, *W_g, L_ss, dS)

    def probe(fac):
        L_ss = fac[2 * G]
        finite = [torch.isfinite(L).flatten(1).all(-1).to(dev) for L in fac[:G]]
        pivots = [amin_inf(_diag(L).flatten(1)).to(dev) for L in fac[:G]]
        # (one group: the reductions over groups are the group's own values)
        ok = reduce(torch.logical_and, finite) & torch.isfinite(L_ss).flatten(1).all(-1)
        # pivot probe: both factors are of unit-diagonal matrices, so a tiny
        # pivot means numerically singular at the factor's precision
        piv = torch.minimum(reduce(torch.minimum, pivots), amin_inf(_diag(L_ss)))
        return ok & (piv > min_pivot)

    def pick(mask, a, b):
        return tuple(select(mask.to(x.device), x, y) for x, y in zip(a, b))

    # the ladder's steps for BBD blocks: a rung's factor input is its delta
    ladder = types.SimpleNamespace(
        chol=lambda: attempt, shifted=lambda t, s, delta: delta, probe=probe, select=pick
    )
    run = Eager()
    run.load({"delta": delta0, "floor": delta_floor, "X": delta0})
    run_ladder(run, ladder, "")
    fac = run.slots["L"]
    L_ss, dS = fac[2 * G:]
    return BbdFactor(
        Li_pp=tuple(_tri_inv_batched(L) for L in fac[:G]), W=fac[G:2 * G],
        Li_ss=_tri_inv_batched(L_ss), dS=dS, delta=run.slots["delta"], ok=run.slots["ok"],
        groups=tuple(groups),
    )


def bbd_solve(fact: BbdFactor, r_pp, r_ss):
    """Solve ``K x = r`` for block right-hand sides ``r_pp`` (B, P, nd[, k]),
    ``r_ss`` (B, ns[, k]) through the explicit inverse factors (matmuls
    only)."""
    vec = r_pp.dim() == 3
    if vec:
        r_pp = r_pp.unsqueeze(-1)
        r_ss = r_ss.unsqueeze(-1)
    dev = r_ss.device
    # forward: y_p = L_pp^-1 r_p;  y_s = Ls^-1 dS (r_s - sum_p W_p' y_p)
    y_p = [
        torch.matmul(Li, r_pp[:, sl].to(gdev))
        for (gdev, sl), Li in zip(fact.groups, fact.Li_pp)
    ]
    t = r_ss - reduce(torch.add, [
        torch.einsum("bpki,bpkr->bir", W, y).to(dev) for W, y in zip(fact.W, y_p)
    ])
    dS = fact.dS.unsqueeze(-1)
    y_s = torch.matmul(fact.Li_ss, dS * t)
    # back: x_s = dS Ls^-T y_s;  x_p = L_pp^-T (y_p - W x_s)
    x_s = dS * torch.matmul(fact.Li_ss.transpose(-1, -2), y_s)
    x_p = [
        torch.matmul(
            Li.transpose(-1, -2), y - torch.matmul(W, x_s.to(y.device).unsqueeze(1))
        ).to(dev)
        for Li, W, y in zip(fact.Li_pp, fact.W, y_p)
    ]
    x_p = x_p[0] if len(x_p) == 1 else torch.cat(x_p, dim=1)
    if vec:
        return x_p.squeeze(-1), x_s.squeeze(-1)
    return x_p, x_s


# --------------------------------------------------------------------------
# block layout maps + structured matvecs
# --------------------------------------------------------------------------


def part_groups(P: int, devices) -> tuple:
    """Split P parts over ``devices`` (which may repeat) in contiguous groups
    by part index, as evenly as possible (the first ``P % len(devices)``
    groups one part larger): ``((devices[g], slice), ...)``; a device left
    without a part gets no group."""
    G = len(devices)
    groups, lo = [], 0
    for g, d in enumerate(devices):
        k = P // G + (g < P % G)
        if k:
            groups.append((torch.device(d), slice(lo, lo + k)))
            lo += k
    return tuple(groups)


class BlockMaps:
    """The index and mask constants of a ``BlockStructure`` on one device,
    with the layout maps and block matvecs shared by the SQP driver and the
    IPM operator.  Every method takes tensors with the lanes on their leading
    axis.

    ``groups`` (:func:`part_groups`) block-shards the factorization; None
    (unsharded) is one group on the lanes' device."""

    def __init__(self, bs, device=None, groups=None):
        self.bs = bs
        dev = torch.device("cpu") if device is None else torch.device(device)
        self.device = dev
        self.groups = groups

        def idx(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

        def msk(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.bool, device=dev)

        P, nd, ns = bs.P, bs.nd, bs.ns
        self.int_idx = idx(bs.int_idx)  # (P, nd), pad = n
        self.int_mask = msk(bs.int_mask)
        self.sep_idx = idx(bs.sep_idx)  # (ns,)
        self.rows = idx(bs.rows)  # (P, mr), pad = m
        self.Aint_mask = msk(bs.Aint_mask)
        self.Asep_mask = msk(bs.Asep_mask)
        self.Hpp_mask = msk(bs.Hpp_mask)
        self.Hps_mask = msk(bs.Hps_mask)
        self.Hss_mask = msk(bs.Hss_mask)
        colorJ_p = np.append(bs.colorJ, 0)
        colorH_p = np.append(bs.colorH, 0)
        self.colJ_int = idx(colorJ_p[bs.int_idx])  # (P, nd)
        self.colJ_sep = idx(bs.colorJ[bs.sep_idx])  # (ns,)
        self.colH_int = idx(colorH_p[bs.int_idx])
        self.colH_sep = idx(bs.colorH[bs.sep_idx])
        self.colorJ = idx(bs.colorJ)
        self.colorH = idx(bs.colorH)
        # the slot of every global variable in [interiors (P*nd) | separator
        # (ns)], and of every global row in the parts' rows (P*mr): the
        # inverse maps, which make scattering back a gather
        var_src = np.empty(bs.n, dtype=np.int64)
        flat = np.asarray(bs.int_idx).reshape(-1)
        real = flat < bs.n
        var_src[flat[real]] = np.nonzero(real)[0]
        var_src[np.asarray(bs.sep_idx)] = P * nd + np.arange(ns)
        row_src = np.empty(bs.m, dtype=np.int64)
        flat = np.asarray(bs.rows).reshape(-1)
        real = flat < bs.m
        row_src[flat[real]] = np.nonzero(real)[0]
        self.var_src = idx(var_src)
        self.row_src = idx(row_src)

    # ------------------------------------------------------------ layout --
    def to_blocks(self, x):
        """(B, n[, k]) -> interiors (B, P, nd[, k]), separator (B, ns[, k])."""
        xp = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        return xp[:, self.int_idx], x[:, self.sep_idx]

    def from_blocks(self, x_p, x_s):
        """Interior and separator blocks back to the global (B, n[, k])."""
        B = x_p.shape[0]
        flat = torch.cat([x_p.reshape((B, -1) + tuple(x_p.shape[3:])), x_s], dim=1)
        return flat[:, self.var_src]

    def rows_gather(self, y):
        """(B, m[, k]) -> (B, P, mr[, k]), zero on padding."""
        yp = torch.cat([y, torch.zeros_like(y[:, :1])], dim=1)
        return yp[:, self.rows]

    def rows_scatter(self, y_p):
        """(B, P, mr[, k]) -> (B, m[, k]); padding slots are dropped."""
        B = y_p.shape[0]
        return y_p.reshape((B, -1) + tuple(y_p.shape[3:]))[:, self.row_src]

    # -------------------------------------------- compressed-AD gathers ---
    def jvp_seeds(self, which: str, dtype) -> torch.Tensor:
        """One-hot JVP seeds of the Jacobian (``"J"``) or Hessian (``"H"``)
        coloring: (ncolors, n), row c the indicator of color c."""
        colors, k = (self.colorJ, self.bs.nJ) if which == "J" else (self.colorH, self.bs.nH)
        return (torch.arange(k, device=self.device)[:, None] == colors[None, :]).to(dtype)

    def jac_blocks(self, JcT) -> JacBlocks:
        """Compressed Jacobian (B, m, nJ) -> :class:`JacBlocks`."""
        JcP = torch.cat([JcT, torch.zeros_like(JcT[:, :1])], dim=1)
        rows = self.rows[:, :, None]
        A_int = torch.where(self.Aint_mask, JcP[:, rows, self.colJ_int[:, None, :]], 0.0)
        A_sep = torch.where(self.Asep_mask, JcP[:, rows, self.colJ_sep[None, None, :]], 0.0)
        return JacBlocks(A_int, A_sep)

    def hess_blocks(self, HcT) -> HessBlocks:
        """Compressed Hessian (B, n, nH) -> :class:`HessBlocks`."""
        HcP = torch.cat([HcT, torch.zeros_like(HcT[:, :1])], dim=1)
        ii = self.int_idx[:, :, None]
        H_pp = torch.where(self.Hpp_mask, HcP[:, ii, self.colH_int[:, None, :]], 0.0)
        H_ps = torch.where(self.Hps_mask, HcP[:, ii, self.colH_sep[None, None, :]], 0.0)
        H_ss = torch.where(
            self.Hss_mask, HcP[:, self.sep_idx[:, None], self.colH_sep[None, :]], 0.0
        )
        return HessBlocks(H_pp, H_ps, H_ss)

    def zero_jac(self, B, dtype, device) -> JacBlocks:
        bs = self.bs
        z = dict(dtype=dtype, device=device)
        return JacBlocks(
            torch.zeros((B, bs.P, bs.mr, bs.nd), **z), torch.zeros((B, bs.P, bs.mr, bs.ns), **z)
        )

    def zero_hess(self, B, dtype, device) -> HessBlocks:
        bs = self.bs
        z = dict(dtype=dtype, device=device)
        return HessBlocks(
            torch.zeros((B, bs.P, bs.nd, bs.nd), **z),
            torch.zeros((B, bs.P, bs.nd, bs.ns), **z),
            torch.zeros((B, bs.ns, bs.ns), **z),
        )

    # ----------------------------------------------------------- matvecs --
    # Each matvec takes (B, n[, k]) or (B, m[, k]): a panel of k columns is
    # one batched product per block, never a per-column copy of the blocks.
    def h_mv(self, H: HessBlocks, x):
        x_p, x_s = self.to_blocks(x)
        y_p = torch.einsum("bpij,bpj...->bpi...", H.H_pp, x_p) + torch.einsum(
            "bpis,bs...->bpi...", H.H_ps, x_s
        )
        y_s = torch.einsum("bpis,bpi...->bs...", H.H_ps, x_p) + torch.einsum(
            "bst,bt...->bs...", H.H_ss, x_s
        )
        return self.from_blocks(y_p, y_s)

    def h_add_diag(self, H: HessBlocks, shift) -> HessBlocks:
        """H + shift I in block form, ``shift`` (B,); padded slots untouched."""
        d = torch.where(self.int_mask, shift[:, None, None], 0.0)
        return HessBlocks(_eye_add(H.H_pp, d), H.H_ps, _eye_add(H.H_ss, shift[:, None]))

    def h_diag_rowabs(self, H: HessBlocks):
        """(diag(H), row sums of |H|) as global vectors: Gershgorin data."""
        row_p = torch.sum(torch.abs(H.H_pp), dim=3) + torch.sum(torch.abs(H.H_ps), dim=3)
        row_s = torch.einsum("bpis->bs", torch.abs(H.H_ps)) + torch.sum(torch.abs(H.H_ss), dim=2)
        return (
            self.from_blocks(_diag(H.H_pp), _diag(H.H_ss)),
            self.from_blocks(row_p, row_s),
        )

    def j_mv(self, J: JacBlocks, x):
        x_p, x_s = self.to_blocks(x)
        y = torch.einsum("bprk,bpk...->bpr...", J.A_int, x_p) + torch.einsum(
            "bprs,bs...->bpr...", J.A_sep, x_s
        )
        return self.rows_scatter(y)

    def j_rmv(self, J: JacBlocks, y):
        y_p = self.rows_gather(y)
        x_p = torch.einsum("bprk,bpr...->bpk...", J.A_int, y_p)
        x_s = torch.einsum("bprs,bpr...->bs...", J.A_sep, y_p)
        return self.from_blocks(x_p, x_s)

    def j_row_norms(self, J: JacBlocks):
        """Per-row 2-norms ||J_i|| as a global (B, m) vector."""
        sq = torch.sum(J.A_int * J.A_int, dim=3) + torch.sum(J.A_sep * J.A_sep, dim=3)
        return torch.sqrt(self.rows_scatter(sq))


# --------------------------------------------------------------------------
# structured KKT operator for the elastic IPM
# --------------------------------------------------------------------------


def part_schur_cap(bs) -> int:
    """Per-part stiff-slot count of the dynamic Schur set: every equality
    slot plus headroom for active inequalities, rounded to a multiple of 8.
    The Schur block is (P * part_schur_cap, P * part_schur_cap)."""
    hp = max(8, (bs.mr - bs.mre + 3) // 4)
    return min(bs.mr, ((bs.mre + hp + 7) // 8) * 8)


#: the most elements of interior Hessian block copies that ``K_mv`` mapped
#: over a panel may make (one copy a column; 8 GiB in float64): a wider panel
#: goes through block products (``BbdOperator.prepare``)
MAPPED_PANEL_ELEMS = 2**30


def _smallest(key, k):
    """Indices of the ``k`` smallest entries along the last axis, ascending,
    ties by index: ``lax.top_k(-key, k)``'s choice and order."""
    return torch.argsort(key, dim=-1, stable=True)[..., :k]


class BbdOperator:
    """Structured stand-in for the dense (Q, A) pair inside the elastic IPM:
    the same interface as ``qp_ipm.DenseOp`` (``q_mv``/``a_mv``/``a_rmv``,
    ``stiff_allowed``/``cap_stiff``, ``prepare``, ``rescue_op``) with the
    Jacobian and Lagrangian Hessian in block form.  One IPM, two
    linear-algebra backends.

    Stiff (Schur-path) rows are selected per part into ``cap_p`` static
    part-local slots (equalities plus near-active inequalities), so the
    dense Schur complement is (P*cap_p, P*cap_p) in part-major order."""

    def __init__(self, maps: BlockMaps, J: JacBlocks, H: HessBlocks, opts):
        self.maps = maps
        self.J = J
        self.H = H
        self.opts = opts
        self.dtype = J.A_int.dtype
        self.fdtype = torch.float32 if opts.factor_dtype == "float32" else self.dtype
        # inner refinement sweeps per K/S application, also with
        # full-precision factors (equilibrated barrier systems of cond ~1e14
        # still gain from ~2 sweeps)
        self.ir_steps = max(2, opts.ir_steps)
        self.Jf = JacBlocks(*(a.to(self.fdtype) for a in J))
        self.Hf = HessBlocks(*(a.to(self.fdtype) for a in H))
        self.cap_p = part_schur_cap(maps.bs)

    def rescue_op(self, keep_cap: bool = False) -> "BbdOperator":
        """Same blocks, full-precision factors: the phase-2 operator.  The
        stiff set is always bounded per part, so ``keep_cap`` changes
        nothing."""
        return BbdOperator(
            self.maps, self.J, self.H,
            dataclasses.replace(self.opts, factor_dtype="same", plane=False),
        )

    def q_mv(self, x):
        return self.maps.h_mv(self.H, x)

    def a_mv(self, x):
        return self.maps.j_mv(self.J, x)

    def a_rmv(self, y):
        return self.maps.j_rmv(self.J, y)

    def stiff_allowed(self):
        return torch.ones((self.maps.bs.m,), dtype=torch.bool, device=self.maps.device)

    def _select(self, stiff, E):
        """Each part's ``cap_p`` stiffest rows (smallest E; non-finite E
        never counts): part-local slot indices (B, P, cap_p) and whether
        each slot holds a stiff row."""
        st_p = self.maps.rows_gather(stiff)
        E_p = self.maps.rows_gather(E)
        key = torch.where(st_p & torch.isfinite(E_p), E_p, _BIG)
        sel = _smallest(key, self.cap_p)
        return sel, torch.gather(st_p, -1, sel), E_p

    def cap_stiff(self, stiff, E, cap):
        """Per-part bounded stiff set; overflow rows fold into K through the
        bounded 1/E.  The IPM's global ``cap`` does not apply here."""
        sel, sel_mask, _ = self._select(stiff, E)
        keep = sel_mask.new_zeros(sel.shape[:-1] + (self.maps.bs.mr,)).scatter(-1, sel, sel_mask)
        return stiff & self.maps.rows_scatter(keep)

    def prepare(self, diag_k, invE_soft, stiff, E_stiff, delta0):
        """Assemble and factor the BBD K and the dense stiff Schur complement;
        return ``(solve_block, delta)``."""
        maps = self.maps
        bs = maps.bs
        fdt, dtype = self.fdtype, self.dtype
        mixed = fdt != dtype
        A_int32, A_sep32 = self.Jf
        H_pp32, H_ps32, H_ss32 = self.Hf
        B = diag_k.shape[0]

        # ---- K blocks: H + diag(diag_k) + A' diag(invE) A (factor dtype) --
        d_p, d_s = maps.to_blocks(diag_k.to(fdt))
        e_rows = maps.rows_gather(invE_soft.to(fdt))  # (B, P, mr)
        AeI = A_int32 * e_rows[..., None]
        K_pp = H_pp32 + torch.einsum("bprk,bprl->bpkl", AeI, A_int32)
        K_pp = _eye_add(K_pp, torch.where(maps.int_mask, d_p, 1.0))  # identity on padding
        K_ps = H_ps32 + torch.einsum("bprk,bprs->bpks", AeI, A_sep32)
        K_ss = H_ss32 + torch.einsum("bprs,bprt->bst", A_sep32 * e_rows[..., None], A_sep32)
        K_ss = _eye_add(K_ss, d_s)

        # Jacobi equilibration: unit-diagonal blocks keep the float32 factor
        # usable across barrier-ill-conditioned iterates
        sc_p = torch.rsqrt(torch.clamp_min(torch.abs(_diag(K_pp)), 1e-30))  # (B, P, nd)
        sc_s = torch.rsqrt(torch.clamp_min(torch.abs(_diag(K_ss)), 1e-30))  # (B, ns)
        K_pp = K_pp * sc_p[..., :, None] * sc_p[..., None, :]
        K_ps = K_ps * sc_p[..., :, None] * sc_s[:, None, None, :]
        K_ss = K_ss * sc_s[:, :, None] * sc_s[:, None, :]

        # pivot probe only for float32 factors; full-precision factors
        # escalate on a non-finite factor alone
        fact = bbd_factorize(
            K_pp, K_ps, K_ss, delta0, min_pivot=1e-3 if mixed else 0.0, groups=maps.groups
        )
        delta64 = fact.delta.to(dtype)
        # the ladder's delta applies to the equilibrated blocks: in unscaled
        # units K + delta diag(K), which the refinement target must match
        diagK = maps.from_blocks((1.0 / (sc_p * sc_p)).to(dtype), (1.0 / (sc_s * sc_s)).to(dtype))

        def solve_K_blocks(r_pp, r_ss):
            """K^-1 in block layout, with the (un)scaling."""
            if r_pp.dim() == 3:
                x_pp, x_ss = bbd_solve(fact, sc_p * r_pp, sc_s * r_ss)
                return sc_p * x_pp, sc_s * x_ss
            x_pp, x_ss = bbd_solve(fact, sc_p[..., None] * r_pp, sc_s[..., None] * r_ss)
            return sc_p[..., None] * x_pp, sc_s[..., None] * x_ss

        q_mv, a_mv, a_rmv = self.q_mv, self.a_mv, self.a_rmv
        kdiag = diag_k + delta64[:, None] * diagK

        def K_mv(x):
            """Exact (K + delta diag(K)) x in the compute dtype, x (B, n)."""
            return q_mv(x) + kdiag * x + a_rmv(invE_soft * a_mv(x))

        def K_mv_panel(X):
            """The same on a panel X (B, n, k).  ``K_mv`` mapped over the k
            columns (``torch.func.vmap``) copies the interior Hessian blocks
            k times; where those copies would pass ``MAPPED_PANEL_ELEMS``
            (12.8e9 elements at case118x12's k = 11016) the panel goes
            through one block product per term instead.  The choice follows
            the shapes alone.  The two forms round differently, and the
            float32-factor paths' iteration counts follow that rounding (the
            mapped form's are JAX's, which maps the same matvec), so the
            smaller panels keep the mapped form."""
            if X.shape[-1] * self.H.H_pp.numel() <= MAPPED_PANEL_ELEMS:
                return torch.func.vmap(K_mv, in_dims=2, out_dims=2)(X)
            return q_mv(X) + kdiag[..., None] * X + a_rmv(invE_soft[..., None] * a_mv(X))

        def solve_K32_g(r):
            """The raw factor applied in the global layout, (B, n[, k])."""
            r_pp, r_ss = maps.to_blocks(r.to(fdt))
            return maps.from_blocks(*solve_K_blocks(r_pp, r_ss))

        def solve_K_ref(r, K_apply):
            """Factor solve plus compute-dtype refinement against the exact
            operator: every K application the IPM sees is accurate to about
            the compute dtype."""
            x = solve_K32_g(r).to(dtype)
            for _ in range(self.ir_steps):
                x = x + solve_K32_g(r - K_apply(x)).to(dtype)
            return x

        # ---- dynamic stiff Schur: per-part slots, part-major ordering ------
        # unused slots carry a zero A-row and a unit diagonal (their dy stays
        # 0: masked rhs)
        P, cap_p = bs.P, self.cap_p
        nst = P * cap_p
        sel, sel_mask, E_sp = self._select(stiff, E_stiff.to(dtype))
        A_int64, A_sep64 = self.J
        smask = sel_mask[..., None]
        A_sel_int = torch.gather(A_int64, 2, sel[..., None].expand(-1, -1, -1, bs.nd)) * smask
        A_sel_sep = torch.gather(A_sep64, 2, sel[..., None].expand(-1, -1, -1, bs.ns)) * smask
        E_sel = torch.where(sel_mask, torch.gather(E_sp, -1, sel), 1.0)

        # A_t' in the global layout (B, n, nst): column q*cap_p + c has
        # interior support only in part q
        eyeP = torch.eye(P, dtype=dtype, device=diag_k.device)
        R_pp = A_sel_int.transpose(-1, -2)[..., None] * eyeP[None, :, None, None, :]
        R_pp = R_pp.movedim(4, 3).reshape(B, P, bs.nd, nst)
        R_ss = A_sel_sep.movedim(-1, 1).reshape(B, bs.ns, nst)
        At_g = maps.from_blocks(R_pp, R_ss)
        AtT = At_g.transpose(-1, -2)

        # refined panel K^-1 A_t' and the compute-dtype Schur complement; S
        # goes through factorize_spd (equilibration, pivot probe, ladder) with
        # solves refined against the compute-dtype S, as the dense S does
        KiA_g = solve_K_ref(At_g, K_mv_panel)
        S = torch.matmul(AtT, KiA_g)
        S = S + torch.diag_embed(E_sel.reshape(B, nst) + (1.0 - sel_mask.reshape(B, nst).to(dtype)))
        fact_S = factorize_spd(
            S, 0.0, factor_dtype=fdt,
            backend=self.opts.kkt_backend, min_pivot=1e-3 if mixed else 0.0,
            equilibrate=True,
        )
        zero = torch.zeros((), dtype=dtype, device=diag_k.device)

        def solve_block(r1, r2_full):
            """Solve [K + delta diag(K), A_t'; A_t, -E_t] with refined inner
            solves; ``r2_full`` (B, m) is masked to the stiff rows and the
            returned dy is full-length with zeros off the stiff set."""
            t = solve_K_ref(r1, K_mv)
            r2 = torch.where(sel_mask, torch.gather(maps.rows_gather(r2_full), -1, sel), zero)
            b = torch.matmul(AtT, t.unsqueeze(-1)).squeeze(-1) - r2.reshape(B, nst)
            dy_sel = solve_factorized(fact_S, b, ir_steps=self.ir_steps)
            dp = t - torch.matmul(KiA_g, dy_sel.unsqueeze(-1)).squeeze(-1)
            d2 = torch.zeros(sel.shape[:-1] + (bs.mr,), dtype=dy_sel.dtype, device=dy_sel.device)
            d2 = d2.scatter(-1, sel, torch.where(sel_mask, dy_sel.reshape(B, P, cap_p), zero))
            return dp, torch.where(stiff, maps.rows_scatter(d2), zero)

        return solve_block, delta64
