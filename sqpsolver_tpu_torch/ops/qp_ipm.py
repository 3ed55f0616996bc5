"""Elastic primal-dual interior-point QP solver (torch port of the JAX
package's ``ops/qp_ipm.py``), batch-first, with two linear-algebra backends:
the dense :class:`DenseOp` (:func:`solve_qp`) and any operator with its
interface, such as the block-structured ``ops.kkt_bbd.BbdOperator``
(:func:`solve_qp_op`).

Canonical elastic form, one instance per lane:

    min_{p,u,v}  1/2 p'Qp + c'p + w'(u + v)
    s.t.         A p + u - v = s,   rl <= s <= ru        (row constraints)
                 lb <= p <= ub                            (box, incl. TR)
                 u >= 0, v >= 0                           (elastic slacks)

Mehrotra predictor-corrector with the hybrid stiff/soft condensation: soft
rows (large elasticity E) fold into K = Q + D_p + A_s' E_s^-1 A_s, stiff rows
solve through the SPD Schur complement S = A_t K^-1 A_t' + diag(E_t), capped
to the ``schur_cap`` stiffest rows when set.  The interior-point loop is a
host loop over the lanes still running (converged, failed and skipped lanes
keep their state bit for bit, as under ``vmap``).

With ``polish_iters > 0`` on float32 factors and float64 data a second loop
continues the same iteration with direct float64 factorizations
(:meth:`DenseOp.rescue_op`): the stall rescue (``qp_rescue``) and the strict
``mixed_polish`` tolerance.  Lanes that phase 1 left strictly converged, and
skipped lanes, take no phase-2 trip and keep their state bit for bit; lanes
converged at the floored phase-1 tolerance continue warm; lanes that left
phase 1 unconverged restart from the cold point.  The Hopper card has
float64 in hardware, so phase 2 is the same host loop with another operator
and needs none of the JAX package's resumable micro-stepping.
``solve_qp.loop_trips`` counts the batched trips of each phase and
``solve_qp.phase_seconds`` the host time spent in each (every trip starts
with the loop's host sync, so this is wall time to within one trip).

With ``plane=True`` on float32 factors (``kkt_precision="mixed_plane"``)
:class:`DenseOp` runs the float32 matrix plane: every matrix product, factor
and back-solve in float32 on Jacobi-equilibrated K and S, the compute dtype
only in vectors and in the refinement of the whole 2x2 block.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from .._lanes import amax0, amin_inf, any_lane, dot, mv, select, true_float32_matmul
from .linsolve import cho_solve, factorize_spd, inv_chol_solve, solve_factorized, tri_inv

_BIG = 1e20  # stand-in for +inf inside masked arithmetic

#: floor for warm-started bound/row duals (keeps every complementarity pair
#: strictly positive)
_WARM_DUAL_FLOOR = 1.0e-2

#: floor of the float32-factorized phase when a float64 phase follows it
_POLISH_FLOOR = 2.0e-6

_STATE_KEYS = ("p", "s", "u", "v", "y", "zl", "zu", "ll", "lu", "zeta_u", "zeta_v")


class QpSolution(NamedTuple):
    """Solution bundle of a batch of elastic QP solves (leading axis = lanes)."""

    p: torch.Tensor
    y: torch.Tensor
    mult_lo: torch.Tensor
    mult_up: torch.Tensor
    slack_u: torch.Tensor
    slack_v: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    pri_res: torch.Tensor
    dual_res: torch.Tensor
    gap: torch.Tensor


@dataclasses.dataclass(frozen=True)
class IpmOptions:
    """Interior-point options, the JAX package's fields and defaults."""

    max_iter: int = 50
    tol: float = 1.0e-10
    ftb: float = 0.995
    fixed_var_ridge: float = 1.0e10
    factor_dtype: str = "same"  # "same" or "float32" (mixed-precision KKT)
    ir_steps: int = 2
    kkt_backend: str = "xla"  # "xla" (cholesky_ex) | "pallas" (hand kernel)
    plane: bool = False
    invert_factors: bool = True
    stall_iters: int = 6
    invE_floor: float = 0.0
    polish_iters: int = 0
    schur_cap: int = 0


class DenseOp:
    """Dense linear algebra of the elastic IPM: batched ``Q`` (B, n, n) and
    ``A`` (B, m, n)."""

    def __init__(self, Q, A, opts: IpmOptions, dtype):
        self.Q = Q
        self.A = A
        self.opts = opts
        self.dtype = dtype
        self.mixed_plane = opts.factor_dtype == "float32" and opts.plane
        self.fdtype = torch.float32 if opts.factor_dtype == "float32" else dtype
        self.ir_steps = opts.ir_steps if opts.factor_dtype == "float32" else 0
        if self.mixed_plane:
            self.Q32 = Q.to(torch.float32)
            self.A32 = A.to(torch.float32)

    def q_mv(self, x):
        return mv(self.Q, x)

    def a_mv(self, x):
        return mv(self.A, x)

    def a_rmv(self, y):
        return mv(self.A.transpose(-1, -2), y)

    def stiff_allowed(self):
        """Rows that may go through the Schur complement: all of them."""
        return torch.ones((self.A.shape[-2],), dtype=torch.bool, device=self.A.device)

    def rescue_op(self, keep_cap: bool = False) -> "DenseOp":
        """Full-precision twin for the phase-2 loop: direct factors in the
        compute dtype over the same ``Q`` and ``A`` (shared, not copied).
        ``keep_cap=True`` (the stall rescue) retains the bounded Schur set;
        the strict ``mixed_polish`` phase lifts it so that nothing blocks
        1e-8-grade dual accuracy."""
        return DenseOp(
            self.Q, self.A,
            dataclasses.replace(
                self.opts, factor_dtype="same", plane=False,
                schur_cap=self.opts.schur_cap if keep_cap else 0,
            ),
            self.dtype,
        )

    def cap_stiff(self, stiff, E, cap):
        """Keep the ``cap`` globally stiffest rows (smallest E, ties by row
        index); non-finite E never counts as stiff."""
        m = self.A.shape[-2]
        if not 0 < cap < m:
            return stiff
        key = torch.where(stiff & torch.isfinite(E), E, _BIG)
        order = torch.argsort(key, dim=-1, stable=True)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(m, device=E.device).expand_as(order)
        )
        return stiff & (rank < cap)

    def prepare(self, diag_k, invE_soft, stiff, E_stiff, delta0):
        """Assemble and factor  K = Q + diag(diag_k) + A' diag(invE) A  and the
        stiff Schur complement  S = A_t K^-1 A_t' + diag(E_t); return
        ``(solve_block, delta)``."""
        if self.mixed_plane:
            with true_float32_matmul():
                return self._prepare_plane(diag_k, invE_soft, stiff, E_stiff, delta0)
        opts, dtype = self.opts, self.dtype
        Q, A = self.Q, self.A
        At = A.transpose(-1, -2)
        K = Q + torch.diag_embed(diag_k) + torch.matmul(At * invE_soft[:, None, :], A)
        mixed = self.fdtype != dtype
        inv = bool(opts.invert_factors)
        kw = dict(
            factor_dtype=self.fdtype, backend=opts.kkt_backend,
            equilibrate=mixed, min_pivot=1e-3 if mixed else 0.0, invert=inv,
        )
        fact_K = factorize_spd(K, delta0, **kw)
        m = A.shape[-2]
        cap = opts.schur_cap
        ir = self.ir_steps
        zero = torch.zeros((), dtype=dtype, device=A.device)
        if 0 < cap < m:
            # gather the capped stiff rows into a compact (cap, n) block;
            # unused slots carry a zero row and unit diagonal
            idx = torch.argsort((~stiff).to(torch.int8), dim=-1, stable=True)[:, :cap]
            sel = torch.gather(stiff, -1, idx)
            A_rows = torch.gather(A, -2, idx[:, :, None].expand(-1, -1, A.shape[-1]))
            A_sel = torch.where(sel[:, :, None], A_rows, zero)
            E_sel = torch.where(sel, torch.gather(E_stiff, -1, idx), 1.0)
            KiAt = solve_factorized(fact_K, A_sel.transpose(-1, -2), ir_steps=ir)
            S = torch.matmul(A_sel, KiAt) + torch.diag_embed(E_sel)
            fact_S = factorize_spd(S, 0.0, **kw)

            def solve_block(r1_t, r2_t):
                t1 = solve_factorized(fact_K, r1_t, ir_steps=ir)
                b_t = mv(A_sel, t1) - torch.where(sel, torch.gather(r2_t, -1, idx), zero)
                dy_sel = solve_factorized(fact_S, b_t, ir_steps=ir)
                dp = t1 - mv(KiAt, dy_sel)
                dy_t = torch.zeros_like(r2_t).scatter_add(
                    -1, idx, torch.where(sel, dy_sel, zero)
                )
                return dp, dy_t

            return solve_block, fact_K.delta

        A_stiff = torch.where(stiff[:, :, None], A, zero)
        KiAt = solve_factorized(fact_K, A_stiff.transpose(-1, -2), ir_steps=ir)
        S = torch.matmul(A_stiff, KiAt) + torch.diag_embed(E_stiff)
        fact_S = factorize_spd(S, 0.0, **kw)

        def solve_block(r1_t, r2_t):
            t1 = solve_factorized(fact_K, r1_t, ir_steps=ir)
            b_t = mv(A_stiff, t1) - r2_t
            dy_t = solve_factorized(fact_S, b_t, ir_steps=ir)
            dp = t1 - mv(KiAt, dy_t)
            return dp, dy_t

        return solve_block, fact_K.delta

    def _prepare_plane(self, diag_k, invE_soft, stiff, E_stiff, delta0):
        """:meth:`prepare` on the float32 matrix plane.  K and S are
        Jacobi-equilibrated (``Ks = dK K dK``, unit diagonal: a barrier
        matrix's ill-conditioning lives mostly in its diagonal) and factored
        with ``min_pivot=1e-3`` through ``opts.kkt_backend``; ``solve_block``
        refines the whole 2x2 block ``max(1, ir_steps)`` times with residuals
        in the compute dtype.  Every float32 product, here and in
        ``solve_block``, runs with TF32 off."""
        opts, dtype = self.opts, self.dtype
        Q, A = self.Q, self.A
        f32 = torch.float32
        B, m, n = A.shape
        zero = torch.zeros((), dtype=dtype, device=A.device)
        A_stiff = torch.where(stiff[:, :, None], A, zero)
        K32 = (
            self.Q32
            + torch.diag_embed(diag_k.to(f32))
            + torch.matmul(self.A32.transpose(-1, -2) * invE_soft.to(f32)[:, None, :], self.A32)
        )
        diagK = torch.clamp_min(torch.abs(torch.diagonal(K32, dim1=-2, dim2=-1)), 1e-30)
        dK = torch.rsqrt(diagK)
        K32s = K32 * dK[:, :, None] * dK[:, None, :]
        fact_K = factorize_spd(K32s, delta0.to(f32), backend=opts.kkt_backend, min_pivot=1e-3)
        solve_Ks = _plane_solver(fact_K.chol, opts.invert_factors)

        def solve_K32(b, vec):
            # K^-1 b = dK Ks^-1 (dK b)
            d = dK if vec else dK[:, :, None]
            return d * solve_Ks(d * b, vec)

        cap = opts.schur_cap
        if 0 < cap < m:
            # the capped stiff rows gathered into a compact (cap, n) block;
            # unused slots carry a zero row and unit diagonal (their dy is 0:
            # the rhs is stiff-masked)
            idx = torch.argsort((~stiff).to(torch.int8), dim=-1, stable=True)[:, :cap]
            sel = torch.gather(stiff, -1, idx)
            A_rows = torch.gather(self.A32, -2, idx[:, :, None].expand(-1, -1, n))
            A_st32 = torch.where(sel[:, :, None], A_rows, 0.0)
            E_s32 = torch.where(sel, torch.gather(E_stiff, -1, idx), 1.0).to(f32)

            def r2_pick(r2):
                return torch.where(sel, torch.gather(r2, -1, idx), zero)

            def dy_unpick(dy):
                return torch.zeros((B, m), dtype=dy.dtype, device=dy.device).scatter_add(
                    -1, idx, torch.where(sel, dy, 0.0)
                )

        else:
            A_st32 = torch.where(stiff[:, :, None], self.A32, 0.0)
            E_s32 = E_stiff.to(f32)

            def r2_pick(r2):
                return r2

            def dy_unpick(dy):
                return dy

        KiAt32 = solve_K32(A_st32.transpose(-1, -2), vec=False)
        S32 = torch.matmul(A_st32, KiAt32) + torch.diag_embed(E_s32)
        dS = torch.rsqrt(torch.clamp_min(torch.abs(torch.diagonal(S32, dim1=-2, dim2=-1)), 1e-30))
        S32s = S32 * dS[:, :, None] * dS[:, None, :]
        fact_S = factorize_spd(S32s, 0.0, backend=opts.kkt_backend, min_pivot=1e-3)
        solve_Ss = _plane_solver(fact_S.chol, opts.invert_factors)

        def solve_S32(b):
            return dS * solve_Ss(dS * b, True)

        delta = fact_K.delta.to(dtype)
        # the ladder added delta to the EQUILIBRATED matrix, i.e. delta *
        # diag(K) in unscaled units: the refinement's target must match it
        # or the sweeps diverge whenever the ladder escalates
        diag_row = diag_k + delta[:, None] * diagK.to(dtype)

        def K_mv(x):
            # (K + delta diag(K)) x in the compute dtype
            return mv(Q, x) + diag_row * x + mv(A.transpose(-1, -2), invE_soft * mv(A, x))

        def approx_block(r1_t, r2_t):
            t1 = solve_K32(r1_t.to(f32), vec=True)
            dy = solve_S32(mv(A_st32, t1) - r2_pick(r2_t).to(f32))
            dp = t1 - mv(KiAt32, dy)
            return dp.to(dtype), dy_unpick(dy).to(dtype)

        def solve_block(r1_t, r2_t):
            """[K + delta diag(K), A_t'; A_t, -E_t] (dp; dy_t) = (r1_t; r2_t)
            by the float32 factors, refined in the compute dtype."""
            with true_float32_matmul():
                dp, dy = approx_block(r1_t, r2_t)
                for _ in range(max(1, self.ir_steps)):
                    res1 = r1_t - (K_mv(dp) + mv(A_stiff.transpose(-1, -2), dy))
                    res2 = r2_t - (mv(A_stiff, dp) - E_stiff * dy)
                    ddp, ddy = approx_block(res1, res2)
                    dp, dy = dp + ddp, dy + ddy
            return dp, dy

        return solve_block, delta


def _plane_solver(L, invert: bool):
    """Back-solves ``b -> (L L^T)^-1 b`` through the plane's float32 factor:
    explicit inverse-factor products when ``invert`` (``opts.invert_factors``),
    else triangular solves.  The returned function takes ``(b, vec)``: a batch
    of vectors (B, n) when ``vec``, of matrices (B, n, k) otherwise."""
    if invert:
        Li = tri_inv(L)
        return lambda b, vec: inv_chol_solve(Li, b, vec=vec)
    return lambda b, vec: cho_solve(L, b, vec=vec)


def _pos(x):
    return torch.clamp_min(x, 0.0)


def _masked_div(num, den, mask):
    """num/den where mask else 0, safe against den == 0 outside the mask."""
    safe = torch.where(mask, den, 1.0)
    return torch.where(mask, num / safe, 0.0)


def _ftb_alpha(a, da, mask, tau):
    """Largest alpha <= 1 with a + alpha*da >= (1-tau)*a over masked entries;
    (B,) per lane."""
    shrink = mask & (da < 0)
    ratio = torch.where(shrink, -a / torch.where(shrink, da, -1.0), torch.inf)
    return torch.clamp_max(tau * amin_inf(ratio), 1.0)


def _min_alpha(pairs, tau):
    """min over (value, direction, mask) triples of the FTB step, in the JAX
    package's pairing order."""
    a = [_ftb_alpha(v, d, msk, tau) for v, d, msk in pairs]
    return torch.minimum(
        torch.minimum(a[0], a[1]),
        torch.minimum(torch.minimum(a[2], a[3]), torch.minimum(a[4], a[5])),
    )


def _col(x):
    return x.unsqueeze(-1)


def solve_qp(
    Q, c, A, rl, ru, lb, ub, w,
    opts: IpmOptions = IpmOptions(),
    skip: Optional[torch.Tensor] = None,
    init: Optional[dict] = None,
    tol_override: Optional[torch.Tensor] = None,
) -> QpSolution:
    """Solve a batch of canonical elastic QPs (module docstring) with dense
    linear algebra.

    Shapes: ``Q`` (B, n, n), ``A`` (B, m, n), ``c``/``lb``/``ub`` (B, n),
    ``rl``/``ru``/``w`` (B, m).  Bounds may be +-inf; equality rows are
    ``rl == ru``; fixed variables ``lb == ub`` are pinned by a ridge penalty.
    ``skip`` (B,) bool: lanes that start converged and take no trips.
    ``init``: warm start dict ``p``, ``y``, ``zl``, ``zu``, ``on`` (B,).
    ``tol_override`` (B,): per-lane relaxation of the tolerance.
    """
    dtype = torch.promote_types(Q.dtype, c.dtype)
    op = DenseOp(Q.to(dtype), A.to(dtype), opts, dtype)
    return solve_qp_op(
        op, c, rl, ru, lb, ub, w, opts=opts, skip=skip, init=init, tol_override=tol_override
    )


def solve_qp_op(
    op, c, rl, ru, lb, ub, w,
    opts: IpmOptions = IpmOptions(),
    skip: Optional[torch.Tensor] = None,
    init: Optional[dict] = None,
    tol_override: Optional[torch.Tensor] = None,
) -> QpSolution:
    """:func:`solve_qp` with the linear algebra of ``op``: a :class:`DenseOp`
    or the block-structured ``ops.kkt_bbd.BbdOperator``, which supply the
    matvecs ``q_mv``/``a_mv``/``a_rmv``, the stiff-row rules
    ``stiff_allowed``/``cap_stiff``, the factor-and-solve ``prepare`` and the
    float64 twin ``rescue_op``.  One IPM body, both phases, either backend."""
    dtype = torch.promote_types(op.dtype, c.dtype)
    c, rl, ru, lb, ub, w = (a.to(dtype) for a in (c, rl, ru, lb, ub, w))
    B, n = c.shape
    m = rl.shape[-1]
    dev = c.device
    do_polish = (
        opts.polish_iters > 0 and opts.factor_dtype == "float32" and dtype == torch.float64
    )
    tau = opts.ftb
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    # ------------------------------------------------------------- masks ----
    eq = torch.isfinite(rl) & (rl == ru)
    hrl = torch.isfinite(rl) & ~eq
    hru = torch.isfinite(ru) & ~eq
    rowbounded = hrl | hru
    freerow = ~eq & ~rowbounded
    fixed = torch.isfinite(lb) & torch.isfinite(ub) & (ub - lb <= 1e-12)
    fixval = torch.where(fixed, 0.5 * (lb + ub), zero)
    lb_eff = torch.where(fixed, fixval - 1.0, lb)
    ub_eff = torch.where(fixed, fixval + 1.0, ub)
    hlb = torch.isfinite(lb_eff)
    hub = torch.isfinite(ub_eff)
    ridge_vec = torch.where(fixed, opts.fixed_var_ridge * one, zero)
    cmod = c - torch.where(fixed, opts.fixed_var_ridge * fixval, zero)
    allowed = op.stiff_allowed()
    ones_m = torch.ones((B, m), dtype=torch.bool, device=dev)

    def qmod_mv(x):
        return op.q_mv(x) + ridge_vec * x

    # ------------------------------------------------------- initial point --
    pad_p = torch.where(
        hlb & hub, torch.clamp_max(0.25 * (ub_eff - lb_eff), 1.0), one
    )
    p = torch.clamp(
        torch.zeros((B, n), dtype=dtype, device=dev),
        min=torch.where(hlb, lb_eff + pad_p, -_BIG),
        max=torch.where(hub, ub_eff - pad_p, _BIG),
    )
    sl_width = torch.where(hrl & hru, ru - rl, torch.inf)
    pad_s = torch.clamp_max(0.25 * sl_width, 1.0)
    s = torch.clamp(
        op.a_mv(p),
        min=torch.where(hrl, rl + pad_s, -_BIG),
        max=torch.where(hru, ru - pad_s, _BIG),
    )
    s = torch.where(eq, rl, s)
    eps_uv = 1.0 / torch.sqrt(w)
    u = eps_uv * torch.ones((B, m), dtype=dtype, device=dev)
    v = eps_uv * torch.ones((B, m), dtype=dtype, device=dev)
    y = torch.zeros((B, m), dtype=dtype, device=dev)
    zl = torch.where(hlb, one, zero)
    zu = torch.where(hub, one, zero)
    ll = torch.where(hrl, one, zero)
    lu = torch.where(hru, one, zero)
    zeta_u = w + y
    zeta_v = w - y
    # the cold point, kept: phase 2 restarts unconverged lanes from it (a warm
    # start that led the float32 phase astray must not also seed the rescue)
    cold_fields = dict(
        p=p, s=s, u=u, v=v, y=y, zl=zl, zu=zu, ll=ll, lu=lu,
        zeta_u=zeta_u, zeta_v=zeta_v,
    )

    # ------------------------------------------------- warm start (opt-in) --
    if init is not None:
        on = init["on"]
        onc = _col(on)
        zf = _WARM_DUAL_FLOOR
        p_w = torch.clamp(
            init["p"].to(dtype),
            min=torch.where(hlb, lb_eff + 0.05 * pad_p, -_BIG),
            max=torch.where(hub, ub_eff - 0.05 * pad_p, _BIG),
        )
        p = torch.where(onc, p_w, p)
        s_w = torch.clamp(
            op.a_mv(p),
            min=torch.where(hrl, rl + 0.05 * pad_s, -_BIG),
            max=torch.where(hru, ru - 0.05 * pad_s, _BIG),
        )
        s = torch.where(eq, rl, torch.where(onc, s_w, s))
        y_w = torch.clamp(init["y"].to(dtype), min=-0.99 * w, max=0.99 * w)
        y = torch.where(onc, y_w, y)
        zeta_u = w + y
        zeta_v = w - y
        zl_w = torch.clamp_min(init["zl"].to(dtype), zf)
        zu_w = torch.clamp_min(init["zu"].to(dtype), zf)
        ll_w = _pos(-y) + zf
        lu_w = _pos(y) + zf
        a_pl_w = torch.where(hlb, p - lb_eff, one)
        a_pu_w = torch.where(hub, ub_eff - p, one)
        a_sl_w = torch.where(hrl, s - rl, one)
        a_su_w = torch.where(hru, ru - s, one)
        tot_w = (
            torch.where(hlb, a_pl_w * zl_w, zero).sum(-1)
            + torch.where(hub, a_pu_w * zu_w, zero).sum(-1)
            + torch.where(hrl, a_sl_w * ll_w, zero).sum(-1)
            + torch.where(hru, a_su_w * lu_w, zero).sum(-1)
            + (u * zeta_u).sum(-1)
            + (v * zeta_v).sum(-1)
        )
        pairs_w = torch.clamp_min(
            (hlb.sum(-1) + hub.sum(-1) + hrl.sum(-1) + hru.sum(-1) + 2 * m).to(dtype),
            1.0,
        )
        lift = _col(0.1 * (tot_w / pairs_w))
        zl_w = torch.maximum(zl_w, lift / a_pl_w)
        zu_w = torch.maximum(zu_w, lift / a_pu_w)
        ll_w = torch.maximum(ll_w, lift / a_sl_w)
        lu_w = torch.maximum(lu_w, lift / a_su_w)
        zl = torch.where(onc & hlb, zl_w, zl)
        zu = torch.where(onc & hub, zu_w, zu)
        ll = torch.where(onc & hrl, ll_w, ll)
        lu = torch.where(onc & hru, lu_w, lu)

    n_pairs = torch.clamp_min(
        (hlb.sum(-1) + hub.sum(-1) + hrl.sum(-1) + hru.sum(-1) + 2 * m).to(dtype),
        1.0,
    )

    def compl_mu(p, s, u, v, zl, zu, ll, lu, zeta_u, zeta_v):
        tot = (
            torch.where(hlb, (p - lb_eff) * zl, zero).sum(-1)
            + torch.where(hub, (ub_eff - p) * zu, zero).sum(-1)
            + torch.where(hrl, (s - rl) * ll, zero).sum(-1)
            + torch.where(hru, (ru - s) * lu, zero).sum(-1)
            + (u * zeta_u).sum(-1)
            + (v * zeta_v).sum(-1)
        )
        return tot / n_pairs

    inf_b = torch.full((B,), torch.inf, dtype=dtype, device=dev)
    skiparr = torch.zeros(B, dtype=torch.bool, device=dev) if skip is None else skip
    st = dict(
        p=p, s=s, u=u, v=v, y=y, zl=zl, zu=zu, ll=ll, lu=lu,
        zeta_u=zeta_u, zeta_v=zeta_v,
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        converged=skiparr.clone(),
        failed=torch.zeros(B, dtype=torch.bool, device=dev),
        since_improve=torch.zeros(B, dtype=torch.int32, device=dev),
        delta=torch.zeros(B, dtype=dtype, device=dev),
        pri_res=inf_b, dual_res=inf_b, gap=inf_b,
        b_p=p, b_y=y, b_zl=zl, b_zu=zu, b_u=u, b_v=v,
        b_err=inf_b, b_pri=inf_b, b_dual=inf_b, b_gap=inf_b,
    )

    c_scale = 1.0 + amax0(torch.abs(c))

    def primal_objective(p, u, v):
        return 0.5 * dot(p, op.q_mv(p)) + dot(c, p) + dot(w, u + v)

    def residuals(st):
        p, s, u, v, y = st["p"], st["s"], st["u"], st["v"], st["y"]
        rd_p = qmod_mv(p) + cmod + op.a_rmv(y) - st["zl"] + st["zu"]
        rp = op.a_mv(p) + u - v - s
        rd_s = torch.where(rowbounded, -y - st["ll"] + st["lu"], zero)
        rd_u = w + y - st["zeta_u"]
        rd_v = w - y - st["zeta_v"]
        return rd_p, rp, rd_s, rd_u, rd_v

    def scaled_residuals(st):
        rd_p, rp, rd_s, rd_u, rd_v = residuals(st)
        pri = amax0(torch.abs(rp)) / (1.0 + amax0(torch.abs(st["s"])))
        dscale = c_scale + amax0(torch.abs(st["y"]))
        dual = (
            torch.maximum(
                amax0(torch.abs(rd_p)),
                torch.maximum(
                    amax0(torch.abs(rd_s)),
                    torch.maximum(amax0(torch.abs(rd_u)), amax0(torch.abs(rd_v))),
                ),
            )
            / dscale
        )
        return pri, dual

    state0 = dict(st)
    # phase 1 stops at the mixed-precision floor when a float64 phase follows;
    # tol_override relaxes both phases, never tightens
    tol_p1 = torch.full(
        (B,), max(opts.tol, _POLISH_FLOOR) if do_polish else opts.tol, dtype=dtype, device=dev
    )
    tol_p2 = torch.full((B,), opts.tol, dtype=dtype, device=dev)
    if tol_override is not None:
        tol_p1 = torch.maximum(tol_p1, tol_override.to(dtype))
        tol_p2 = torch.maximum(tol_p2, tol_override.to(dtype))

    def body(st, lop, tol, cap, guard):
        """One interior-point trip on every lane with operator ``lop``; the
        stall and divergence cutoffs apply only under ``guard`` (phase 1)."""
        p, s, u, v = st["p"], st["s"], st["u"], st["v"]
        y, zl, zu, ll, lu = st["y"], st["zl"], st["zu"], st["ll"], st["lu"]
        zeta_u, zeta_v = st["zeta_u"], st["zeta_v"]
        a_pl = torch.where(hlb, p - lb_eff, one)
        a_pu = torch.where(hub, ub_eff - p, one)
        a_sl = torch.where(hrl, s - rl, one)
        a_su = torch.where(hru, ru - s, one)
        rd_p, rp, rd_s, rd_u, rd_v = residuals(st)
        mu = compl_mu(p, s, u, v, zl, zu, ll, lu, zeta_u, zeta_v)

        # hybrid split: soft rows (large E) fold into K, stiff rows go
        # through the Schur complement (capped to the stiffest rows)
        Dp = _masked_div(zl, a_pl, hlb) + _masked_div(zu, a_pu, hub)
        Ds = _masked_div(ll, a_sl, hrl) + _masked_div(lu, a_su, hru)
        eu = u / zeta_u
        ev = v / zeta_v
        E = eu + ev + _masked_div(torch.ones_like(Ds), Ds, rowbounded)
        soft = (E > 1.0) | freerow
        # rows outside the operator's allowed set fold into K whatever their
        # E; the operator may shrink the stiff set to its capacity
        stiff = lop.cap_stiff(~soft & allowed, E, cap)
        elim = ~stiff & ~freerow
        invE_soft = torch.where(elim, 1.0 / torch.clamp_min(E, opts.invE_floor), zero)
        E_stiff = torch.where(stiff, E, one)
        solve_block, fact_delta = lop.prepare(
            ridge_vec + Dp, invE_soft, stiff, E_stiff, st["delta"]
        )

        def newton(cc_pl, cc_pu, cc_sl, cc_su, cc_u, cc_v):
            r1 = -rd_p + _masked_div(cc_pl, a_pl, hlb) - _masked_div(cc_pu, a_pu, hub)
            ts = -rd_s + _masked_div(cc_sl, a_sl, hrl) - _masked_div(cc_su, a_su, hru)
            rhs2 = (
                -rp - cc_u / zeta_u + eu * rd_u + cc_v / zeta_v - ev * rd_v
                + _masked_div(ts, Ds, rowbounded)
            )
            r1_t = r1 + op.a_rmv(invE_soft * rhs2 + torch.where(freerow, y, zero))
            dp, dy_t = solve_block(r1_t, torch.where(stiff, rhs2, zero))
            Adp = op.a_mv(dp)
            dy_soft = torch.where(elim, (Adp - rhs2) * invE_soft, -y)
            dy = torch.where(stiff, dy_t, dy_soft)
            du = cc_u / zeta_u - eu * (dy + rd_u)
            dv = cc_v / zeta_v - ev * (rd_v - dy)
            ds = _masked_div(dy + ts, Ds, rowbounded)
            ds = torch.where(freerow, Adp + du - dv + rp, ds)
            dzl = _masked_div(cc_pl - zl * dp, a_pl, hlb)
            dzu = _masked_div(cc_pu + zu * dp, a_pu, hub)
            dll = _masked_div(cc_sl - ll * ds, a_sl, hrl)
            dlu = _masked_div(cc_su + lu * ds, a_su, hru)
            return dp, ds, du, dv, dy, dzl, dzu, dll, dlu, dy + rd_u, rd_v - dy

        def steps(d, tau_):
            dp, ds, du, dv, _, dzl, dzu, dll, dlu, dzeta_u, dzeta_v = d
            ap = _min_alpha(
                [(a_pl, dp, hlb), (a_pu, -dp, hub), (a_sl, ds, hrl),
                 (a_su, -ds, hru), (u, du, ones_m), (v, dv, ones_m)], tau_,
            )
            ad = _min_alpha(
                [(zl, dzl, hlb), (zu, dzu, hub), (ll, dll, hrl), (lu, dlu, hru),
                 (zeta_u, dzeta_u, ones_m), (zeta_v, dzeta_v, ones_m)], tau_,
            )
            return ap, ad

        # predictor (stage 0, zero previous direction) then corrector
        d = tuple(torch.zeros_like(t) for t in (p, s, u, v, y, zl, zu, ll, lu, zeta_u, zeta_v))
        for k in range(2):
            dp_a, ds_a, du_a, dv_a, _, dzl_a, dzu_a, dll_a, dlu_a, dzu_ua, dzv_va = d
            ap_a, ad_a = steps(d, 1.0)
            aa = _col(torch.minimum(ap_a, ad_a))
            mu_aff = compl_mu(
                p + aa * dp_a, s + aa * ds_a, u + aa * du_a, v + aa * dv_a,
                zl + aa * dzl_a, zu + aa * dzu_a, ll + aa * dll_a, lu + aa * dlu_a,
                zeta_u + aa * dzu_ua, zeta_v + aa * dzv_va,
            )
            sigma = torch.clamp((mu_aff / torch.clamp_min(mu, 1e-300)) ** 3, 0.0, 1.0)
            smu = _col(float(k > 0) * sigma * mu)
            d = newton(
                torch.where(hlb, smu - a_pl * zl - dp_a * dzl_a, zero),
                torch.where(hub, smu - a_pu * zu - (-dp_a) * dzu_a, zero),
                torch.where(hrl, smu - a_sl * ll - ds_a * dll_a, zero),
                torch.where(hru, smu - a_su * lu - (-ds_a) * dlu_a, zero),
                smu - u * zeta_u - du_a * dzu_ua,
                smu - v * zeta_v - dv_a * dzv_va,
            )
        dp, ds, du, dv, dy, dzl, dzu, dll, dlu, dzeta_u, dzeta_v = d
        ap, ad = steps(d, tau)
        alpha = _col(torch.minimum(ap, ad))
        new = dict(st)
        new["p"] = p + alpha * dp
        new["s"] = torch.where(eq, rl, s + alpha * ds)
        new["u"] = u + alpha * du
        new["v"] = v + alpha * dv
        new["y"] = y + alpha * dy
        new["zl"] = torch.where(hlb, zl + alpha * dzl, zero)
        new["zu"] = torch.where(hub, zu + alpha * dzu, zero)
        new["ll"] = torch.where(hrl, ll + alpha * dll, zero)
        new["lu"] = torch.where(hru, lu + alpha * dlu, zero)
        new["zeta_u"] = zeta_u + alpha * dzeta_u
        new["zeta_v"] = zeta_v + alpha * dzeta_v
        new["delta"] = fact_delta.to(dtype) * 0.1
        new["iters"] = st["iters"] + 1

        pri, dual = scaled_residuals(new)
        mu_total = compl_mu(
            new["p"], new["s"], new["u"], new["v"], new["zl"], new["zu"],
            new["ll"], new["lu"], new["zeta_u"], new["zeta_v"],
        )
        obj_scale = 1.0 + torch.abs(primal_objective(new["p"], new["u"], new["v"]))
        gap = mu_total * n_pairs / obj_scale
        new["pri_res"], new["dual_res"], new["gap"] = pri, dual, gap
        new["converged"] = (pri < tol) & (dual < tol) & (gap < tol)

        # best iterate, stall and divergence cutoffs
        err = torch.maximum(pri, torch.maximum(dual, gap))
        better = err < st["b_err"]
        usable = st["b_err"] < torch.sqrt(tol)
        improved10 = err < 0.9 * st["b_err"]
        new["since_improve"] = torch.where(
            usable & ~improved10, st["since_improve"] + 1, 0
        ).to(torch.int32)
        if opts.stall_iters > 0 and guard:
            new["failed"] = new["failed"] | (new["since_improve"] >= opts.stall_iters)
        for key in ("p", "y", "zl", "zu", "u", "v"):
            new["b_" + key] = select(better, new[key], st["b_" + key])
        for key, val in (("err", err), ("pri", pri), ("dual", dual), ("gap", gap)):
            new["b_" + key] = torch.where(better, val, st["b_" + key])
        if guard:
            diverging = err > 1.0e4 * torch.maximum(new["b_err"], tol)
            new["failed"] = new["failed"] | diverging

        # numerical-breakdown backstop: revert to the previous iterate, stop
        finite = torch.ones(B, dtype=torch.bool, device=dev)
        for key in _STATE_KEYS:
            finite = finite & torch.isfinite(new[key]).all(-1)
        out = {k: select(finite, new[k], st[k]) for k in new}
        out["failed"] = torch.where(finite, new["failed"], True)
        out["iters"] = new["iters"]
        return out

    def run_phase(st, phase, lop, tol, max_iter_, cap, guard):
        t0 = time.perf_counter()
        while True:
            active = ~st["converged"] & ~st["failed"] & (st["iters"] < max_iter_)
            if not any_lane(active):
                solve_qp.phase_seconds[phase] += time.perf_counter() - t0
                return st
            solve_qp.loop_trips[phase] += 1
            new = body(st, lop, tol, cap, guard)
            st = {k: select(active, new[k], st[k]) for k in st}

    st = run_phase(st, 1, op, tol_p1, opts.max_iter, opts.schur_cap, True)
    if do_polish:
        # phase 2: lanes strictly converged (or skipped) take zero trips;
        # lanes converged at the floored tolerance continue warm; lanes that
        # left phase 1 unconverged restart cold with exact factors (a float32
        # exit is typically jammed at a degenerate corner where exact Newton
        # steps cannot recover either).  The best iterate spans both phases.
        strict_polish = float(opts.tol) < _POLISH_FLOOR
        strict = (st["pri_res"] < tol_p2) & (st["dual_res"] < tol_p2) & (st["gap"] < tol_p2)
        done2 = strict | skiparr
        cold = ~done2 & ~st["converged"]
        state0_cold = dict(state0, **cold_fields)
        st = {
            k: v if k.startswith("b_") else select(cold, state0_cold[k], v)
            for k, v in st.items()
        }
        st["converged"] = done2
        st["failed"] = torch.zeros_like(done2)
        st["since_improve"] = torch.zeros_like(st["since_improve"])
        st = run_phase(
            st, 2, op.rescue_op(keep_cap=not strict_polish), tol_p2,
            opts.max_iter + opts.polish_iters, 0 if strict_polish else opts.schur_cap, False,
        )

    # finalize: the best iterate seen
    pri, dual, gap = st["b_pri"], st["b_dual"], st["b_gap"]
    converged = (pri < opts.tol) & (dual < opts.tol) & (gap < opts.tol)
    redcost_fixed = op.q_mv(st["b_p"]) + c + op.a_rmv(st["b_y"])
    return QpSolution(
        p=torch.where(fixed, fixval, st["b_p"]),
        y=st["b_y"],
        mult_lo=torch.where(fixed, _pos(redcost_fixed), st["b_zl"]),
        mult_up=torch.where(fixed, _pos(-redcost_fixed), st["b_zu"]),
        slack_u=st["b_u"],
        slack_v=st["b_v"],
        iters=st["iters"],
        converged=converged,
        pri_res=pri,
        dual_res=dual,
        gap=gap,
    )


#: batched loop trips (body invocations) taken so far, by phase
solve_qp.loop_trips = {1: 0, 2: 0}
#: host seconds spent in each phase's loop so far
solve_qp.phase_seconds = {1: 0.0, 2: 0.0}
