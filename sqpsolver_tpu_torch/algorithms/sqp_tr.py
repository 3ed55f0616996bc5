"""Trust-region SQP driver (torch port of the JAX package's
``algorithms/sqp_tr.py``), dense and batch-first.

The JAX driver is one instance's ``lax.while_loop`` batched by ``vmap``; here
every tensor of the solver state carries the lanes on its leading axis, the
outer loop runs on the host until no lane is live, and a lane that is done
keeps its state bit for bit (``_lanes.select``).  Per-lane control flow
(accept/reject, feasibility-restoration entry/exit, status rules) is masked
arithmetic, term for term as in the JAX package.

Ported: ``init_state`` with the initial linear-feasibility projection,
``stage_refresh``, ``convexify`` (``ladder``, ``eigh`` on float32,
``power`` (the Lanczos bound), ``gershgorin``), ``subproblem_inputs``,
``triage_subproblem``, the second-order correction (``soc_inputs``),
``stages_post_qp`` and ``stages_accept`` with FR and the status rules, and
``finalize``; ``qp_rescue`` and ``mixed_polish`` hand the IPM its float64
phase 2.  The solve function carries its three stages as ``init_state``,
``run_until`` and ``finalize`` for the chunked batch solver and the
checkpointed solve.  The iteration printer (``OutputFlag``) prints the JAX
package's lines for a one-lane solve; per-iteration statistics
(``StatisticsFlag``) fill fixed ``(B, max_iter + 1)`` tensors, one row per
iteration of each lane.

``run_until``'s iteration is written as stretches between its host points
(``ops/stretches.py``): ``refresh`` (the evaluations, the convexified
Hessian and the QP's inputs), the QP call, ``post`` (the post-QP stages,
to the end of the iteration or to the SOC's QP call), and with ``use_soc``
the SOC's QP call and ``soc``; the ``eigh`` shift's eigenvalue call splits
``refresh`` at an ``inputs`` stretch, a one-lane verbose solve prints its
line after ``post``, and the loop's sync reads the mask that the last
stretch wrote.  For the dense operator on a CUDA device each stretch is
replayed as a CUDA graph, kept in the solver's own ``stretches.Plans``
(the graphs read its model's constants); ``stage_graphs`` counts their
captures and replays.  The structured mode and every solve on the CPU run
the same stretches as plain calls.

Structured mode (``kkt_structured=True``, an NLP with a ``structure``): the
derivatives arrive coloring-compressed (``nJ`` Jacobian JVPs and ``nH``
Hessian-vector products, forward over reverse, per lane) and are gathered
into bordered-block-diagonal blocks (``ops.kkt_bbd.JacBlocks`` /
``HessBlocks``), and the QPs run through ``BbdOperator`` in the same IPM.
"""

from __future__ import annotations

import dataclasses
import math
import time
import types
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from .._lanes import amax0, any_lane, dot, map_lanes, mv, select, true_float32_matmul
from ..nlp import NLP, NLPData, initial_point
from ..ops.kkt_bbd import BbdOperator, BlockMaps, HessBlocks, part_groups
from ..ops.qp_ipm import IpmOptions, solve_qp, solve_qp_op
from ..ops.stretches import Eager, Plans, flat_trees
from ..parameters import Parameters
from ..status import Status
from ..structure import build_block_structure
from .common import (
    kt_residuals_from_parts,
    lanczos_lmin_bound,
    norm_violations,
    schur_cap_for,
)

#: consecutive stalled-QP iterations tolerated before a lane fails with
#: ERROR_IN_STEP_COMPUTATION (each stall halves the TR)
_QP_BAD_MAX = 3

#: CUDA graphs of the iteration's stretches captured, and replays of them, by
#: every solver so far (their hit share is replays / (replays + captures));
#: ``solve_qp.graph_captures`` / ``graph_replays`` count the QP trip's apart
stage_graphs = types.SimpleNamespace(graph_captures=0, graph_replays=0)

#: the state fields that the refresh of an iteration evaluates anew
_REFRESHED = ("f", "df", "E", "J", "H", "prim_infeas", "dual_infeas")


def _inf_norm(x):
    return amax0(torch.abs(x))


def _dropzeros(x, tol=1e-10):
    return torch.where(torch.abs(x) < tol, 0.0, x)


def _col(x):
    return x.unsqueeze(-1)


@dataclasses.dataclass
class SqpState:
    """Batched solver state; every field has the lanes on its leading axis."""

    x: torch.Tensor
    lam: torch.Tensor
    mult_lo: torch.Tensor
    mult_up: torch.Tensor
    f: torch.Tensor
    df: torch.Tensor
    E: torch.Tensor
    J: torch.Tensor  # (B, m, n), or ops.kkt_bbd.JacBlocks in structured mode
    H: torch.Tensor  # (B, n, n), or ops.kkt_bbd.HessBlocks
    prim_infeas: torch.Tensor
    dual_infeas: torch.Tensor
    p: torch.Tensor
    phi: torch.Tensor
    mu: torch.Tensor
    tr: torch.Tensor
    step_accepted: torch.Tensor
    fr: torch.Tensor
    iter: torch.Tensor
    ret: torch.Tensor
    done: torch.Tensor
    qp_iters_total: torch.Tensor
    n_accept: torch.Tensor
    n_reject: torch.Tensor
    n_soc_accept: torch.Tensor
    n_fr_iters: torch.Tensor
    n_qp_bad: torch.Tensor
    #: per-iteration statistics (``StatisticsFlag``): a dict of ``(B,
    #: max_iter + 1)`` tensors, row ``iter`` written by each iteration
    stats: Optional[dict] = None

    def replace(self, **kw) -> "SqpState":
        return dataclasses.replace(self, **kw)


def _select_tree(mask, a, b):
    """Per-lane select over a tree of tensors (a state, a block tuple)."""
    return map_lanes(lambda x, y: select(mask, x, y), a, b)


class SqpResult(NamedTuple):
    """Batched result (the JAX package's ``SqpResult`` fields)."""

    x: torch.Tensor
    obj_val: torch.Tensor
    status: torch.Tensor
    g: torch.Tensor
    mult_g: torch.Tensor
    mult_x_L: torch.Tensor
    mult_x_U: torch.Tensor
    iterations: torch.Tensor
    prim_infeas: torch.Tensor
    dual_infeas: torch.Tensor
    qp_iters_total: torch.Tensor
    n_accept: torch.Tensor
    n_reject: torch.Tensor
    n_soc_accept: torch.Tensor
    n_fr_iters: torch.Tensor
    stats: Optional[dict] = None


def structured_derivatives(nlp: NLP, maps: BlockMaps, x, lam, theta, exact_hessian=True):
    """Coloring-compressed derivatives in block form, per lane: the
    Jacobian from ``nJ`` JVPs of ``g`` and the Lagrangian Hessian from
    ``nH`` JVPs of its gradient (forward over reverse), one one-hot seed per
    color, gathered by ``maps`` into :class:`JacBlocks` / :class:`HessBlocks`.
    ``x`` (B, n), ``lam`` (B, m), ``theta`` a dict of (B, ...) tensors or
    None."""
    th_dim = 0 if (nlp.theta is not None and theta is not None) else None
    seedsJ = maps.jvp_seeds("J", x.dtype)

    def lane_jac(z, th):
        return vmap(lambda s: jvp(lambda v: nlp.cons(v, th), (z,), (s,))[1])(seedsJ)

    J = maps.jac_blocks(vmap(lane_jac, in_dims=(0, th_dim))(x, theta).transpose(-1, -2))
    if not exact_hessian:  # SLP mode: LP subproblems
        return J, maps.zero_hess(x.shape[0], x.dtype, x.device)
    seedsH = maps.jvp_seeds("H", x.dtype)

    def lane_hess(z, lm, th):
        def lagrangian(v):
            val = nlp.obj(v, th)
            if nlp.g is not None:
                val = val + torch.dot(lm, nlp.cons(v, th))
            return val

        glag = grad(lagrangian)
        return vmap(lambda s: jvp(glag, (z,), (s,))[1])(seedsH)

    Hc = vmap(lane_hess, in_dims=(0, 0, th_dim))(x, lam, theta)
    return J, maps.hess_blocks(Hc.transpose(-1, -2))


def _trust_region_box(x, x_l, x_u, tr):
    """TR box in step space with the degenerate-interval guard."""
    trc = _col(tr)
    v_lb = x_l - x
    v_ub = x_u - x
    lb = torch.maximum(-trc, v_lb)
    ub = torch.minimum(trc, v_ub)
    bad = lb > ub
    lb = torch.where(bad, torch.maximum(-trc, torch.clamp_max(v_lb, 0.0)), lb)
    ub = torch.where(bad, torch.minimum(trc, torch.clamp_min(v_ub, 0.0)), ub)
    return lb, ub


def make_solver(
    nlp: NLP,
    params: Parameters = Parameters(),
    *,
    verbose: Optional[bool] = None,
    block_shard=None,
) -> Callable[[NLPData], SqpResult]:
    """Build the batched SQP-TR solve function: batched :class:`NLPData`
    (every tensor with a leading lane axis) -> batched :class:`SqpResult`.
    Each solve runs with TF32 matmuls off and restores the caller's
    float32 matmul precision when it returns.

    ``verbose`` (default ``params.OutputFlag``) prints a header and one line
    per SQP iteration, as the JAX package does, when the batch has one lane;
    a batch of several lanes prints nothing.

    ``block_shard=mesh`` (structured mode only): split the BBD part axis
    over ``mesh.devices`` (``ops.kkt_bbd.part_groups``);
    ``params.kkt_parts`` must be a multiple of the mesh size (0, the
    partition's own count, is)."""
    if params.algorithm != "SQP-TR":
        raise ValueError(f"make_solver builds SQP-TR; got algorithm={params.algorithm!r}")
    structured = bool(params.kkt_structured)
    if structured and nlp.structure is None:
        raise ValueError(
            "kkt_structured=True requires nlp.structure (see "
            "sqpsolver_tpu_torch.structure.NLPStructure; models can also use "
            "structure.detect_structure)"
        )
    if block_shard is not None:
        if not structured:
            raise ValueError("block sharding requires kkt_structured=True")
        if params.kkt_parts % len(block_shard.devices):
            raise ValueError(
                f"block sharding: kkt_parts={params.kkt_parts} is not a multiple of the "
                f"mesh's {len(block_shard.devices)} devices"
            )
    collect_stats = bool(params.StatisticsFlag)
    log_iters = bool(params.OutputFlag) if verbose is None else verbose
    solve_t0 = [0.0]
    n, m = nlp.n, nlp.m
    n_lin = nlp.num_linear
    dtype = torch.float64 if params.dtype == "float64" else torch.float32
    exact_hessian = params.hessian_type == "exact"
    use_soc = bool(params.use_soc)
    mixed = params.kkt_precision.startswith("mixed")
    # float32-factorized KKT (mixed modes, and the structured backend's
    # factors in any mode) bottoms out around 1e-6 on barrier-ill-conditioned
    # systems; "mixed_polish" continues past that floor with float64 factors
    qp_tol_eff = max(params.qp_tol, 30.0 * float(torch.finfo(dtype).eps))
    polish = (
        params.kkt_precision == "mixed_polish" and not structured and dtype == torch.float64
    )
    if (mixed or structured) and not polish:
        qp_tol_eff = max(qp_tol_eff, 2.0e-6)
    schur_cap = schur_cap_for(params, nlp)
    polish_iters = (
        20
        if polish
        else (8 if ((mixed or structured) and dtype == torch.float64 and params.qp_rescue) else 0)
    )
    ipm_opts = IpmOptions(
        max_iter=params.qp_max_iter,
        tol=qp_tol_eff,
        ftb=params.qp_ftb,
        factor_dtype="float32" if mixed else "same",
        ir_steps=(
            max(4, params.kkt_ir_steps)
            if schur_cap
            else (
                max(2, params.kkt_ir_steps)
                if params.kkt_precision == "mixed_plane"
                else params.kkt_ir_steps
            )
        ),
        kkt_backend=params.kkt_backend,
        plane=params.kkt_precision == "mixed_plane",
        # bounded condensation of the rows folded into K past the Schur set
        invE_floor=3.0e-7 if (structured or schur_cap) else 0.0,
        polish_iters=polish_iters,
        schur_cap=schur_cap,
    )
    w_big = params.elastic_weight
    tol_dir = params.tol_direction
    tol_res = params.tol_residual
    tol_inf = params.tol_infeas
    max_iter = params.max_iter
    tr_max = 1.0e8

    # ---------------------------------------------- structured (BBD) mode ---
    if structured:
        g_l_np = np.broadcast_to(np.asarray(nlp.g_l, dtype=np.float64), (m,))
        g_u_np = np.broadcast_to(np.asarray(nlp.g_u, dtype=np.float64), (m,))
        bs = build_block_structure(
            n, m, nlp.structure, np.isfinite(g_l_np) & (g_l_np == g_u_np),
            n_parts=(params.kkt_parts or None),
        )
        groups = None if block_shard is None else part_groups(bs.P, block_shard.devices)
        per_device = {}

        def block_maps(ref: torch.Tensor) -> BlockMaps:
            """The block maps on ``ref``'s device (the lanes'; a block shard's
            part groups go by part index, whatever devices they name)."""
            if ref.device not in per_device:
                per_device[ref.device] = BlockMaps(bs, ref.device, groups=groups)
            return per_device[ref.device]

        def jac_mv(J, p):
            return block_maps(p).j_mv(J, p)

        def jac_rmv(J, y):
            return block_maps(y).j_rmv(J, y)

        def jac_row_norms(J):
            return block_maps(J.A_int).j_row_norms(J)

        def hess_mv(H, v):
            return block_maps(v).h_mv(H, v)

        def qp_solve(Q, c, J, rl, ru, lb, ub, w, skip, init, tol_dyn):
            op = BbdOperator(block_maps(c), J, Q, ipm_opts)
            return solve_qp_op(
                op, c, rl, ru, lb, ub, w, opts=ipm_opts, skip=skip, init=init,
                tol_override=tol_dyn,
            )

    else:

        def jac_mv(J, p):
            return mv(J, p)

        def jac_rmv(J, y):
            return mv(J.transpose(-1, -2), y)

        def jac_row_norms(J):
            return torch.sqrt(torch.sum(J * J, dim=-1))

        def hess_mv(H, v):
            return mv(H, v)

        def qp_solve(Q, c, J, rl, ru, lb, ub, w, skip, init, tol_dyn):
            return solve_qp(
                Q, c, J, rl, ru, lb, ub, w, opts=ipm_opts, skip=skip, init=init,
                tol_override=tol_dyn,
            )

    # ------------------------------------------------------------- evals ----
    def eval_all(x, lam, theta):
        f, df = nlp.obj_grad(x, theta)
        _, E = nlp.obj_cons(x, theta)
        if structured:
            J, H = structured_derivatives(nlp, block_maps(x), x, lam, theta, exact_hessian)
            return f, df, E, J, H
        J = nlp.cons_jac(x, theta)
        if exact_hessian:
            H = nlp.lag_hess(x, lam, theta)
        else:
            H = x.new_zeros((x.shape[0], n, n))
        return f, df, E, J, H

    def viol1(E, x, d: NLPData):
        return norm_violations(E, d.g_l, d.g_u, x, d.x_l, d.x_u, ord=1)

    def merit(f_val, E_val, x_val, mu, fr, d):
        v = viol1(E_val, x_val, d)
        phi = torch.where(fr, v, f_val + mu * v)
        return torch.where(torch.isfinite(phi), phi, torch.inf)

    # ---------------------------------------------------------- QP solves ---
    def _gershgorin_data(H):
        """(diag, off-diagonal |row| sums), dense or block form."""
        if structured:
            diag, rowabs = block_maps(H.H_ss).h_diag_rowabs(H)
            return diag, rowabs - torch.abs(diag)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        return diag, torch.sum(torch.abs(H), dim=-1) - torch.abs(diag)

    def _add_diag(H, shift):
        """H + shift I per lane, ``shift`` (B,)."""
        if structured:
            return block_maps(H.H_ss).h_add_diag(H, shift)
        return H + shift[:, None, None] * torch.eye(n, dtype=dtype, device=H.device)

    def convexify(H, lmin32=None):
        """Shift an indefinite Lagrangian Hessian toward PSD (per lane).
        The ``eigh`` shift takes the float32 smallest eigenvalues ``lmin32``
        of ``H`` from :func:`smallest_eig32`."""
        if not exact_hessian:
            return H
        if params.hessian_shift == "ladder":
            # no global shift: only the f32-factorability floor; the KKT
            # factorization's delta ladder regularizes per IPM iteration
            diag_g, off_g = _gershgorin_data(H)
            return _add_diag(H, 4.0e-7 * (1.0 + amax0(torch.abs(diag_g) + off_g)))
        if params.hessian_shift == "gershgorin":
            diag, off = _gershgorin_data(H)
            lmin = torch.clamp_max(torch.amin(diag - off, dim=-1), 0.0)
        elif params.hessian_shift == "power" or structured:
            # Lanczos lower bound on lambda_min: matvecs only, so it serves
            # the block form too (no dense H exists there; "eigh" comes here)
            ref = H.H_ss if structured else H
            lmin = lanczos_lmin_bound(
                lambda v: hess_mv(H, v), ref.shape[0], n, dtype, ref.device,
                iters=(params.hessian_shift_iters or min(n, 64)),
            )
        else:  # "eigh": float32 smallest eigenvalue, padded by f32 eps * |H|
            pad = 4.0e-7 * amax0(torch.abs(H).flatten(-2))
            lmin = lmin32.to(dtype) - pad
        if mixed or structured:  # float32 factors need a curvature floor
            diag_g, off_g = _gershgorin_data(H)
            floor = 4.0e-7 * (1.0 + amax0(torch.abs(diag_g) + off_g))
        else:
            floor = 1e-8 * (1.0 + torch.abs(lmin))
        shift = torch.clamp_min(-lmin, 0.0) + torch.where(lmin < floor, floor, 0.0)
        return _add_diag(H, shift)

    #: the dense ``eigh`` shift's eigenvalue call is a host point of the
    #: iteration (it reads its status on the host)
    eig_host = exact_hessian and params.hessian_shift == "eigh" and not structured

    def smallest_eig32(H32):
        return torch.linalg.eigvalsh(H32)[:, 0]

    def _adaptive_qp_tol(st: SqpState):
        if params.qp_tol_adaptive <= 0.0:
            return None
        kkt_err = torch.maximum(st.prim_infeas, st.dual_infeas)
        return torch.clamp(params.qp_tol_adaptive * kkt_err, 0.0, 1.0e-3)

    def subproblem_inputs(st: SqpState, d: NLPData, H_qp):
        """Problem data of the normal/FR trust-region QP, by input selection."""
        rl = d.g_l - st.E
        ru = d.g_u - st.E
        lb, ub = _trust_region_box(st.x, d.x_l, d.x_u, st.tr)
        is_linear_row = torch.arange(m, device=st.E.device) < n_lin
        violated = (st.E < d.g_l) | (st.E > d.g_u)
        freed = violated & ~is_linear_row
        frc = _col(st.fr)
        w = torch.where(frc & freed, 1.0, torch.full_like(st.E, w_big))
        c = torch.where(frc, 0.0, st.df)
        init = None
        if params.qp_warm_start:
            init = dict(
                p=torch.where(_col(st.step_accepted), 0.0, st.p),
                y=st.lam,
                zl=st.mult_lo,
                zu=st.mult_up,
                on=(st.iter > 1) & ~st.fr,
            )
        if structured:
            Q = HessBlocks(*(select(st.fr, torch.zeros_like(h), h) for h in H_qp))
        else:
            Q = torch.where(st.fr[:, None, None], 0.0, H_qp)
        return Q, c, rl, ru, lb, ub, w, init, _adaptive_qp_tol(st), freed

    def triage_subproblem(st: SqpState, d: NLPData, sol, freed):
        """TR-vs-true-bound dual masking, the infeasibility certificate and
        the stalled-QP signal."""
        trc = _col(st.tr)
        bound_lo_active = (d.x_l - st.x) >= -trc
        bound_up_active = (d.x_u - st.x) <= trc
        sol = sol._replace(
            mult_lo=torch.where(bound_lo_active, sol.mult_lo, 0.0),
            mult_up=torch.where(bound_up_active, sol.mult_up, 0.0),
        )
        hard = torch.where(_col(st.fr), ~freed, True)
        hard_slack = amax0(torch.where(hard, sol.slack_u + sol.slack_v, 0.0))
        rough = qp_tol_eff**0.5
        rough_dual = max(rough, 3e-2)
        rough_exit = ~sol.converged & ((sol.pri_res > rough) | (sol.dual_res > rough_dual))
        infeasible = (hard_slack > params.qp_infeas_tol) & sol.converged
        qp_bad = rough_exit & ~infeasible
        return sol, infeasible, qp_bad

    def soc_inputs(st: SqpState, E_trial, d: NLPData, try_soc, duals):
        """Second-order correction QP: the subproblem with its rows shifted
        by the curvature residual at the trial point, E_soc = g(x+p) - J p;
        its solution is the whole corrected step (the JAX package's fix of
        the reference's double-added base step).  Lanes not trying skip.
        Its inputs besides ``H_qp``, ``st.df`` and ``st.J``."""
        E_soc = E_trial - jac_mv(st.J, st.p)
        lb, ub = _trust_region_box(st.x, d.x_l, d.x_u, st.tr)
        init = None
        if params.qp_warm_start:
            y_w, zl_w, zu_w = duals
            init = dict(p=st.p, y=y_w, zl=zl_w, zu=zu_w, on=try_soc)
        return dict(
            rl=d.g_l - E_soc, ru=d.g_u - E_soc, lb=lb, ub=ub,
            w=torch.full_like(st.E, w_big), skip=~try_soc, init=init,
            tol=_adaptive_qp_tol(st),
        )

    def qmodel(st: SqpState, p, d: NLPData, with_step):
        """q(p) = df'p + 1/2 p'Hp + mu * ||linearized viol||_1."""
        if with_step:
            qval = dot(st.df, p) + 0.5 * dot(p, hess_mv(st.H, p))
            E_lin = st.E + jac_mv(st.J, p)
            x_t = st.x + p
        else:
            qval = torch.zeros_like(st.mu)
            E_lin = st.E
            x_t = st.x
        return qval + st.mu * viol1(E_lin, x_t, d)

    # ------------------------------------------------------------ logging ---
    def log_values(st: SqpState):
        """The values of a one-lane solve's iteration line, on the device
        (None where nothing is printed)."""
        if not log_iters or st.x.shape[0] != 1:
            return None
        lmax = torch.maximum(
            _inf_norm(st.lam), torch.maximum(_inf_norm(st.mult_lo), _inf_norm(st.mult_up))
        )
        return torch.stack([
            v[0].to(torch.float64) for v in (
                st.iter, st.step_accepted, st.fr, st.f, st.phi, st.mu, lmax, st.tr,
                _inf_norm(st.p), st.prim_infeas, st.dual_infeas,
            )
        ])

    def print_log(vals):
        """Print the iteration line: its values come to the host in one
        transfer."""
        it, acc, fr, f, phi, mu, lmax, tr, pnorm, pr, du = vals.tolist()
        mark = "FR" if fr else "  "
        a = "a" if acc else "r"
        pr_s = f"{pr:6.8e}" if math.isfinite(pr) else "           Inf"
        du_s = f"{du:6.8e}" if math.isfinite(du) else "           Inf"
        print(
            f"{mark}{int(it):6d}{a}  {f:+6.8e}  {phi:+6.8e}"
            f"  {mu:+6.8e}  {lmax:+6.8e}  {tr:6.8e}"
            f"  {pnorm:6.8e}  {pr_s}  {du_s}"
            f"  {time.time() - solve_t0[0]:10.2f}"
        )

    # ------------------------------------------------------- statistics -----
    def init_stats(B, device):
        if not collect_stats:
            return None

        def z(dt=dtype):
            return torch.zeros((B, max_iter + 1), dtype=dt, device=device)

        return dict(
            f=z(), phi=z(), mu=z(), tr=z(), p_norm=z(),
            inf_pr=z(), inf_du=z(), qp_iters=z(),
            accepted=z(torch.int32), fr=z(torch.int32),
        )

    def record_stats(st: SqpState, qp_iters):
        """Write this iteration's row (``iter``, clipped to ``max_iter``) of
        every lane; lanes that are done get theirs back from the loop's
        select."""
        if not collect_stats:
            return st.stats
        i = torch.clamp(st.iter, 0, max_iter).to(torch.int64)[:, None]
        vals = dict(
            f=st.f, phi=st.phi, mu=st.mu, tr=st.tr, p_norm=_inf_norm(st.p),
            inf_pr=st.prim_infeas, inf_du=st.dual_infeas, qp_iters=qp_iters.to(dtype),
            accepted=st.step_accepted.to(torch.int32), fr=st.fr.to(torch.int32),
        )
        return {k: st.stats[k].scatter(1, i, v[:, None]) for k, v in vals.items()}

    # ----------------------------------------------------------- the loop ---
    def stage_refresh(st: SqpState, d: NLPData) -> SqpState:
        """Refresh evaluations on lanes whose last step was accepted."""
        f, df, E, J, H = eval_all(st.x, st.lam, d.theta)
        prim = viol1(E, st.x, d)
        dual = kt_residuals_from_parts(
            df, st.lam, st.mult_up, st.mult_lo, jac_rmv(J, st.lam), jac_row_norms(J),
        )
        acc = st.step_accepted
        return st.replace(
            f=select(acc, f, st.f), df=select(acc, df, st.df), E=select(acc, E, st.E),
            J=_select_tree(acc, J, st.J), H=_select_tree(acc, H, st.H),
            prim_infeas=select(acc, prim, st.prim_infeas),
            dual_infeas=select(acc, dual, st.dual_infeas),
        )

    def stages_post_qp(st: SqpState, d: NLPData, sol, qp_infeasible, qp_bad):
        """Dual/penalty bookkeeping, status triage, merit/convergence tests
        and the trial step's merit, up to the SOC: the state and what
        :func:`stages_accept` reads besides (``ctx``; with ``use_soc``, the
        SOC QP's inputs under ``soc_in``; the iteration line's values under
        ``log``)."""
        failed = qp_infeasible | qp_bad
        fc = _col(failed)
        p = torch.where(fc, 0.0, sol.p)
        p_lam = torch.where(fc, 0.0, sol.y - st.lam)
        p_mlo = torch.where(fc, 0.0, sol.mult_lo - st.mult_lo)
        p_mup = torch.where(fc, 0.0, sol.mult_up - st.mult_up)
        lam_max = torch.maximum(
            _inf_norm(st.lam), torch.maximum(_inf_norm(st.mult_lo), _inf_norm(st.mult_up))
        )
        mu = torch.maximum(st.mu, lam_max)
        # also track the fresh QP multipliers (x1.1), clamped to 1e4x the
        # accepted ones; FR iterations excluded
        mu_fresh = 1.1 * torch.maximum(
            _inf_norm(sol.y), torch.maximum(_inf_norm(sol.mult_lo), _inf_norm(sol.mult_up))
        )
        mu_fresh = torch.minimum(mu_fresh, 1.0e4 * (1.0 + lam_max))
        use_fresh = ~failed & ~st.fr
        mu = torch.maximum(mu, torch.where(use_fresh, mu_fresh, 0.0))
        mu = torch.clamp_max(mu, params.max_mu)
        st = st.replace(p=p, mu=mu, qp_iters_total=st.qp_iters_total + sol.iters)
        p_norm = _inf_norm(p)
        live = ~st.done

        # 3a. possibly unbounded: TR at max and the step on its boundary
        on_boundary_loose = p_norm >= (1.0 - 1.0e-5) * st.tr
        unbounded = ~failed & (st.tr == tr_max) & on_boundary_loose
        set_unbounded = live & unbounded
        st = st.replace(
            ret=torch.where(set_unbounded, int(Status.DIVERGING_ITERATES), st.ret),
            done=st.done | set_unbounded,
        )
        live = ~st.done

        # 3b. infeasible QP: enter FR, or fail out of FR
        fr_fail_ret = torch.where(
            st.prim_infeas <= tol_inf,
            int(Status.FEASIBLE_POINT_FOUND),
            int(Status.INFEASIBLE_PROBLEM_DETECTED),
        ).to(torch.int32)
        set_fr_fail = live & qp_infeasible & st.fr
        st = st.replace(
            ret=torch.where(set_fr_fail, fr_fail_ret, st.ret),
            done=st.done | set_fr_fail,
        )
        live = ~st.done
        fr_enter = live & qp_infeasible & ~st.fr
        phi_fr = viol1(st.E, st.x, d)
        st = st.replace(
            fr=st.fr | fr_enter,
            phi=torch.where(fr_enter, phi_fr, st.phi),
            n_fr_iters=st.n_fr_iters + fr_enter.to(torch.int32),
        )

        # 3c. stalled QP: halve the TR and retry, fatal after _QP_BAD_MAX
        n_qp_bad = torch.where(qp_bad, st.n_qp_bad + 1, 0).to(torch.int32)
        fatal_bad = qp_bad & (n_qp_bad >= _QP_BAD_MAX)
        bad_retry = live & qp_bad & ~fatal_bad
        bad_ret = torch.where(
            st.prim_infeas <= tol_inf * 10.0,
            int(Status.FEASIBLE_POINT_FOUND),
            int(Status.ERROR_IN_STEP_COMPUTATION),
        ).to(torch.int32)
        set_bad = live & fatal_bad
        st = st.replace(
            n_qp_bad=n_qp_bad,
            ret=torch.where(set_bad, bad_ret, st.ret),
            done=st.done | set_bad,
            tr=torch.where(bad_retry, torch.clamp_min(0.5 * st.tr, 0.1 * tol_dir), st.tr),
            step_accepted=torch.where(bad_retry, False, st.step_accepted),
            n_reject=st.n_reject + bad_retry.to(torch.int32),
        )
        live = ~st.done
        live_step = live & ~fr_enter & ~bad_retry

        # 4. refresh the merit after accepted steps, with the current mu
        phi_new = merit(st.f, st.E, st.x, st.mu, st.fr, d)
        st = st.replace(phi=torch.where(live_step & st.step_accepted, phi_new, st.phi))

        log = log_values(st)
        st = st.replace(stats=record_stats(st, sol.iters))

        # 5. tiny direction: in FR exit restoration (or declare infeasible
        #    when clearly infeasible); otherwise converged
        tiny = p_norm <= tol_dir
        tiny_live = live_step & tiny
        fr_tiny = tiny_live & st.fr
        fr_stuck = fr_tiny & (st.prim_infeas > tol_inf**0.5)
        fr_exit_tiny = fr_tiny & ~fr_stuck
        conv_tiny = tiny_live & ~st.fr
        phi_normal = st.f + st.mu * viol1(st.E, st.x, d)
        st = st.replace(
            fr=st.fr & ~fr_exit_tiny,
            phi=torch.where(fr_exit_tiny, phi_normal, st.phi),
            ret=torch.where(
                conv_tiny,
                int(Status.SOLVE_SUCCEEDED),
                torch.where(fr_stuck, int(Status.INFEASIBLE_PROBLEM_DETECTED), st.ret),
            ).to(torch.int32),
            done=st.done | conv_tiny | fr_stuck,
        )
        live_step = live_step & ~tiny

        # 6. KKT convergence test
        kkt_ok = (
            (st.prim_infeas <= tol_inf)
            & (st.dual_infeas <= tol_res)
            & ~on_boundary_loose
            & ~st.fr
        )
        conv_kkt = live_step & kkt_ok
        st = st.replace(
            ret=torch.where(conv_kkt, int(Status.SOLVE_SUCCEEDED), st.ret),
            done=st.done | conv_kkt,
        )
        live_step = live_step & ~kkt_ok

        # 7. accept/reject the step, with the optional SOC on rejection
        x_t = st.x + st.p
        f_t, E_t = nlp.obj_cons(x_t, d.theta)
        phi_t = merit(f_t, E_t, x_t, st.mu, st.fr, d)
        ared = st.phi - phi_t
        q0 = qmodel(st, st.p, d, with_step=False)
        qk = qmodel(st, st.p, d, with_step=True)
        pred = torch.where(st.fr, 1.0, q0 - qk)
        rho = ared / pred
        accept = (ared > 0.0) & (rho > 0.0)
        new_lam = st.lam + p_lam
        new_mlo = st.mult_lo + p_mlo
        new_mup = st.mult_up + p_mup
        ctx = dict(
            live=live, live_step=live_step, p_norm=p_norm, on_boundary_loose=on_boundary_loose,
            accept=accept, q0=q0, x_t=x_t, new_lam=new_lam, new_mlo=new_mlo, new_mup=new_mup,
        )
        out = dict(ctx=ctx, log=log)
        if use_soc:
            ctx["try_soc"] = ~accept & (viol1(E_t, x_t, d) > 0.0) & ~st.fr & live_step
            out["soc_in"] = soc_inputs(st, E_t, d, ctx["try_soc"], (new_lam, new_mlo, new_mup))
        return st, out

    def stages_accept(st: SqpState, d: NLPData, ctx: dict, soc=None) -> SqpState:
        """The SOC's merit and acceptance (``soc``: its QP's step and
        trips), the TR update and the counters."""
        live, live_step, p_norm = ctx["live"], ctx["live_step"], ctx["p_norm"]
        accept, q0 = ctx["accept"], ctx["q0"]
        new_x = ctx["x_t"]
        soc_accept = torch.zeros_like(accept)
        soc_qp_iters = torch.zeros_like(st.iter)
        if use_soc:
            try_soc = ctx["try_soc"]
            p_soc, soc_qp_iters = soc["p"], soc["iters"]
            x_soc = st.x + p_soc
            f_soc, E_soc_t = nlp.obj_cons(x_soc, d.theta)
            ared_soc = st.phi - merit(f_soc, E_soc_t, x_soc, st.mu, st.fr, d)
            pred_soc = torch.where(st.fr, 1.0, q0 - qmodel(st, p_soc, d, with_step=True))
            soc_accept = try_soc & (ared_soc > 0.0) & (ared_soc / pred_soc > 0.0)
            new_x = select(soc_accept, x_soc, new_x)
        any_accept = accept | soc_accept

        # TR update: expand only on a plain accept that hit the boundary
        tr_exp = torch.where(
            accept & ctx["on_boundary_loose"], torch.clamp_max(2.0 * st.tr, tr_max), st.tr
        )
        tr_shrink = torch.clamp_min(0.5 * torch.minimum(st.tr, p_norm), 0.1 * tol_dir)
        new_tr = torch.where(any_accept, tr_exp, tr_shrink)
        upd = live_step & any_accept
        st = st.replace(
            x=select(upd, new_x, st.x),
            lam=select(upd, ctx["new_lam"], st.lam),
            mult_lo=select(upd, ctx["new_mlo"], st.mult_lo),
            mult_up=select(upd, ctx["new_mup"], st.mult_up),
            tr=torch.where(live_step, new_tr, st.tr),
            step_accepted=torch.where(live_step, any_accept, st.step_accepted),
            n_accept=st.n_accept + upd.to(torch.int32),
            n_reject=st.n_reject + (live_step & ~any_accept).to(torch.int32),
            n_soc_accept=st.n_soc_accept + (live_step & soc_accept).to(torch.int32),
            qp_iters_total=st.qp_iters_total + torch.where(live_step, soc_qp_iters, 0),
        )
        # 8. FR exit on an accepted step; 9. iteration counter
        st = st.replace(fr=st.fr & ~(live_step & any_accept))
        return st.replace(iter=st.iter + live.to(torch.int32))

    # ------------------------------------------------------ initialization --
    def init_state(d: NLPData) -> SqpState:
        theta = d.theta
        x0 = initial_point(d)
        B, dev = x0.shape[0], x0.device
        lam = x0.new_zeros((B, m)) if d.lam0 is None else d.lam0.to(dtype)
        # structured mode skips the projection (its QP would need the dense
        # Jacobian): supply a linear-feasible x0 there (ACOPF starts are)
        project = n_lin > 0 and params.init_projection != "off" and not structured
        if project:
            f0, df0, E0, J0, H0 = eval_all(x0, lam, theta)
        else:
            f0, E0 = nlp.obj_cons(x0, theta)
            df0 = x0.new_zeros((B, n))
            if structured:
                maps = block_maps(x0)
                J0 = maps.zero_jac(B, dtype, dev)
                H0 = maps.zero_hess(B, dtype, dev)
            else:
                J0 = x0.new_zeros((B, m, n))
                H0 = x0.new_zeros((B, n, n))
        mlo = x0.new_zeros((B, n))
        mup = x0.new_zeros((B, n))
        if project:
            # min ||x - x0||^2 over the linear rows and bounds; lanes already
            # linear-feasible skip
            lpviol = (
                torch.clamp_min(d.g_l[:, :n_lin] - E0[:, :n_lin], 0.0)
                + torch.clamp_min(E0[:, :n_lin] - d.g_u[:, :n_lin], 0.0)
            ).sum(-1) + (
                torch.clamp_min(d.x_l - x0, 0.0) + torch.clamp_min(x0 - d.x_u, 0.0)
            ).sum(-1)
            do_proj = lpviol > tol_inf
            is_linear_row = torch.arange(m, device=dev) < n_lin
            proj = solve_qp(
                2.0 * torch.eye(n, dtype=dtype, device=dev).expand(B, n, n),
                -2.0 * x0,
                J0,
                torch.where(is_linear_row, d.g_l, -torch.inf),
                torch.where(is_linear_row, d.g_u, torch.inf),
                d.x_l,
                d.x_u,
                torch.full((B, m), w_big, dtype=dtype, device=dev),
                opts=ipm_opts,
                skip=~do_proj,
            )
            x0 = select(do_proj, _dropzeros(proj.p), x0)
            lam = select(do_proj, _dropzeros(proj.y), lam)
            mlo = select(do_proj, _dropzeros(proj.mult_lo), mlo)
            mup = select(do_proj, _dropzeros(proj.mult_up), mup)
        nan_f = ~torch.isfinite(f0)

        def full(val, dt=dtype):
            return torch.full((B,), val, dtype=dt, device=dev)

        i32 = torch.int32
        return SqpState(
            x=x0, lam=lam, mult_lo=mlo, mult_up=mup,
            f=f0, df=df0, E=E0, J=J0, H=H0,
            prim_infeas=full(torch.inf), dual_infeas=full(torch.inf),
            p=x0.new_zeros((B, n)),
            phi=full(1.0e20), mu=full(params.init_mu), tr=full(params.tr_size),
            step_accepted=full(True, torch.bool), fr=full(False, torch.bool),
            iter=full(1, i32),
            ret=torch.where(
                nan_f, int(Status.INVALID_NUMBER_DETECTED), int(Status.OPTIMIZE_NOT_CALLED)
            ).to(i32),
            done=nan_f,
            qp_iters_total=full(0, i32), n_accept=full(0, i32), n_reject=full(0, i32),
            n_soc_accept=full(0, i32), n_fr_iters=full(0, i32), n_qp_bad=full(0, i32),
            stats=init_stats(B, dev),
        )

    # ------------------------------------------------ the loop's stretches --
    # Each reads named trees of the run (``get``): the loop state ``st``, the
    # data ``d``, ``limit``, the loop's mask ``active``, and what the
    # iteration made so far; it returns new ones.

    def next_mask(st: SqpState, limit):
        return dict(active=~st.done & (st.iter <= limit))

    def end_iteration(get, st: SqpState) -> dict:
        """The lanes of the loop's mask take the iteration's state; the next
        sync's mask."""
        st = _select_tree(get("active"), st, get("st"))
        return dict(st=st, **next_mask(st, get("limit")))

    def refreshed(get) -> SqpState:
        return get("st").replace(**get("fresh"))

    def qp_inputs(st: SqpState, d: NLPData, H_qp) -> dict:
        Q, c, rl, ru, lb, ub, w, init, tol_dyn, freed = subproblem_inputs(st, d, H_qp)
        out = dict(
            qp_in=dict(Q=Q, c=c, rl=rl, ru=ru, lb=lb, ub=ub, w=w, init=init, tol=tol_dyn),
            freed=freed,
        )
        if use_soc:
            out["H_qp"] = H_qp
        return out

    def s_refresh(get) -> dict:
        """Evaluations at the accepted steps, the convexified Hessian and
        the QP's inputs (with the ``eigh`` shift, up to its eigenvalue
        call)."""
        st = stage_refresh(get("st"), get("d"))
        out = dict(fresh={k: getattr(st, k) for k in _REFRESHED})
        if eig_host:
            out["H32"] = st.H.to(torch.float32)
        else:
            out.update(qp_inputs(st, get("d"), convexify(st.H)))
        return out

    def s_inputs(get) -> dict:
        st = refreshed(get)
        return qp_inputs(st, get("d"), convexify(st.H, get("lmin32")))

    def s_post(get) -> dict:
        """Triage of the QP's answer and the post-QP stages, to the end of
        the iteration or, with ``use_soc``, to the SOC's QP call."""
        base, d = refreshed(get), get("d")
        sol, qp_infeasible, qp_bad = triage_subproblem(base, d, get("qp"), get("freed"))
        st, out = stages_post_qp(base, d, sol, qp_infeasible, qp_bad)
        if use_soc:
            out["mid"] = {
                f.name: getattr(st, f.name) for f in dataclasses.fields(SqpState)
                if getattr(st, f.name) is not getattr(base, f.name)
            }
            return out
        return dict(end_iteration(get, stages_accept(st, d, out["ctx"])), log=out["log"])

    def s_soc(get) -> dict:
        st = refreshed(get).replace(**get("mid"))
        return end_iteration(get, stages_accept(st, get("d"), get("ctx"), get("soc")))

    # the graphs read this solver's model constants: its own cache
    plans = Plans(stage_graphs)

    def stage_runner(trees: dict):
        """The run of one ``run_until`` call: its stretches replayed as CUDA
        graphs for the dense operator on a CUDA device, else plain calls."""
        dev = trees["st"].x.device
        run = Eager() if structured else plans.run(dev, None, flat_trees(trees))
        run.load_trees(trees)
        return run

    # ------------------------------------------------------------- driver ---
    def run_until(st: SqpState, d: NLPData, limit) -> SqpState:
        """Advance every live lane until done or ``iter > limit``.  The
        iteration runs as stretches between its host points: the QP call,
        the ``eigh`` shift's eigenvalue call, the SOC's QP call, the
        iteration line (a one-lane verbose solve) and the loop's sync."""
        limit_t = torch.full((), limit, dtype=st.iter.dtype, device=st.iter.device)
        run = stage_runner(dict(st=st, d=d, limit=limit_t))
        run.tree_stretch("start", lambda get: next_mask(get("st"), get("limit")))
        while run.sync("active"):
            run.tree_stretch("refresh", s_refresh)
            if eig_host:
                run.factor(smallest_eig32, "H32", "lmin32")
                run.tree_stretch("inputs", s_inputs)
            q, fresh = run.tree("qp_in"), run.tree("fresh")
            sol = qp_solve(
                q["Q"], q["c"], fresh["J"], q["rl"], q["ru"], q["lb"], q["ub"], q["w"],
                run.tree("st.done"), q["init"], q["tol"],
            )
            run.load_trees(dict(qp=sol))
            run.tree_stretch("post", s_post)
            log = run.tree("log")
            if log is not None:
                print_log(log)
            if use_soc:
                q, fresh = run.tree("soc_in"), run.tree("fresh")
                sol = qp_solve(
                    run.tree("H_qp"), fresh["df"], fresh["J"], q["rl"], q["ru"], q["lb"],
                    q["ub"], q["w"], q["skip"], q["init"], q["tol"],
                )
                run.load_trees(dict(soc=dict(p=sol.p, iters=sol.iters)))
                run.tree_stretch("soc", s_soc)
        return run.export_tree("st")

    def finalize(st: SqpState, d: NLPData) -> SqpResult:
        limit_ret = torch.where(
            st.prim_infeas <= tol_inf,
            int(Status.FEASIBLE_POINT_FOUND),
            int(Status.MAXIMUM_ITERATIONS_EXCEEDED),
        ).to(torch.int32)
        ret = torch.where(~st.done, limit_ret, st.ret)
        obj_val, g_out = nlp.obj_cons(st.x, d.theta)
        return SqpResult(
            x=st.x,
            obj_val=-obj_val if nlp.maximize else obj_val,
            status=ret,
            g=g_out,
            mult_g=st.lam,
            mult_x_L=st.mult_lo,
            mult_x_U=st.mult_up,
            iterations=st.iter,
            prim_infeas=st.prim_infeas,
            dual_infeas=st.dual_infeas,
            qp_iters_total=st.qp_iters_total,
            n_accept=st.n_accept,
            n_reject=st.n_reject,
            n_soc_accept=st.n_soc_accept,
            n_fr_iters=st.n_fr_iters,
            stats=st.stats,
        )

    def solve(d: NLPData) -> SqpResult:
        solve_t0[0] = time.time()
        if log_iters and d.x0.shape[0] == 1:
            print(
                f"  {'iter':>6}   {'f(x_k)':>15}  {'phi(x_k)':>15}  {'mu':>15}"
                f"  {'|lam|inf':>15}  {'Delta':>14}  {'|p|':>14}"
                f"  {'inf_pr':>14}  {'inf_du':>14}  {'time':>10}"
            )
        with true_float32_matmul():
            return finalize(run_until(init_state(d), d, max_iter), d)

    def staged(fn):
        def stage(*args):
            with true_float32_matmul():
                return fn(*args)

        return stage

    # the three stages, each under the solve's matmul precision, for callers
    # that advance the state in chunks (parallel.batch)
    solve.init_state = staged(init_state)
    solve.run_until = staged(run_until)
    solve.finalize = staged(finalize)
    #: this solver's runs of graphed stretches, by what their graphs depend on
    solve.stage_plans = plans
    return solve
