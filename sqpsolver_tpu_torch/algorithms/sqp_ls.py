"""Line-search SQP driver, ``algorithm="SQP-LS"`` (torch port of the JAX
package's ``algorithms/sqp_ls.py``), dense and batch-first.

The JAX package revives the reference's line-search variant from its
dead-code spec (the reference's ``src/algorithms/sqp_line_search.jl``).
Semantics, term for term as there:

* QP subproblem with a fixed box |p| <= 1000 (``sqp_line_search.jl:255``);
* per-constraint vector penalty ``mu`` (starts at 10) with update rule 2
  (``compute_mu_rule2!``, ``:279-291``): the first iteration sets
  ``mu_i = (df'p + max(0.5 p'Hp, 0)) / max((1-rho) viol_1, 1e-8)``,
  afterwards ``mu_i = max(mu_i, |lambda_i|)``;
* Armijo backtracking on the l1 merit: the first ``alpha`` of
  ``1, tau, tau^2, ...`` (``n_bt`` of them, down to ``min_alpha``) with
  ``phi(x + alpha p) <= phi + eta * alpha * D``, ``D = df'p - mu . viol``;
* a second-order correction step on line-search failure, which the lane
  takes INSTEAD of ``alpha p`` (the JAX package's fix of the spec's
  double-added base step);
* multipliers replaced (not incremented) by the QP duals each iteration;
* convergence: tiny direction, or prim-infeasibility (inf-norm) with
  complementarity and dual residual (``:172-192``); feasibility restoration
  entered on an infeasible QP and left on a tiny direction or a
  near-feasible point.

As in the port's SQP-TR driver, every tensor of the state carries the lanes
on its leading axis, the outer loop runs on the host until no lane is live,
and a lane that is done keeps its state bit for bit.  The JAX package's
Armijo search is a ``lax.scan`` over all ``n_bt`` trial steps with no early
exit; here the same ``n_bt`` trial points of every lane are evaluated in ONE
batched call (:func:`armijo_search`), not in a host loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from .._lanes import amax0, any_lane, dot, map_lanes, mv, select, true_float32_matmul
from ..nlp import NLP, NLPData, initial_point
from ..ops.qp_ipm import IpmOptions, solve_qp
from ..parameters import Parameters
from ..status import Status
from .common import (
    constraint_violation,
    kt_residuals,
    lanczos_lmin_bound,
    norm_complementarity,
    norm_violations,
    schur_cap_for,
)
from .merit import merit_derivative
from .sqp_tr import SqpResult

_LS_TR = 1000.0  # fixed step box of the LS subproblem (sqp_line_search.jl:255)


@dataclasses.dataclass
class LsState:
    """Batched line-search state; every field has the lanes on its leading
    axis (``mu``: per-constraint penalties, ``(B, m)``)."""

    x: torch.Tensor
    lam: torch.Tensor
    mult_lo: torch.Tensor
    mult_up: torch.Tensor
    mu: torch.Tensor
    f: torch.Tensor
    prim_infeas: torch.Tensor
    dual_infeas: torch.Tensor
    compl: torch.Tensor
    p: torch.Tensor
    phi: torch.Tensor
    alpha: torch.Tensor
    fr: torch.Tensor
    iter: torch.Tensor
    ret: torch.Tensor
    done: torch.Tensor
    qp_iters_total: torch.Tensor
    n_soc: torch.Tensor

    def replace(self, **kw) -> "LsState":
        return dataclasses.replace(self, **kw)


def _bound_viol(x, d: NLPData):
    return torch.sum(torch.clamp_min(d.x_l - x, 0.0) + torch.clamp_min(x - d.x_u, 0.0), dim=-1)


def ls_merit(f_val, E_val, x_val, mu, fr, d: NLPData):
    """The line search's l1 merit ``phi = f + mu . viol + max(mu) * bound
    viol`` (per-row penalties ``mu``, ``(B, m)``); the plain sum of
    violations on lanes in FR; ``inf`` where it is not finite.  ``f_val``,
    ``E_val`` and ``x_val`` may carry extra leading axes (the trial steps)."""
    cv = constraint_violation(E_val, d.g_l, d.g_u)
    bv = _bound_viol(x_val, d)
    # max(mu, initial=1.0): 1.0 when there is no row
    mu_max = torch.clamp_min(amax0(mu), 1.0)
    phi = torch.where(
        fr, torch.sum(cv, dim=-1) + bv, f_val + torch.sum(mu * cv, dim=-1) + mu_max * bv
    )
    return torch.where(torch.isfinite(phi), phi, torch.inf)


def backtracking_alphas(tau: float, min_alpha: float, dtype) -> torch.Tensor:
    """The trial step lengths ``1, tau, tau^2, ...`` of the Armijo search,
    ``n_bt = ceil(log(min_alpha) / log(tau))`` of them (at least one), each
    the previous times ``tau`` rounded in ``dtype`` as the JAX scan forms
    them, on the CPU."""
    n_bt = max(1, int(math.ceil(math.log(max(min_alpha, 1e-16)) / math.log(tau))))
    kind = np.float64 if dtype == torch.float64 else np.float32
    out = np.empty(n_bt, kind)
    alpha = kind(1.0)
    for k in range(n_bt):
        out[k] = alpha
        alpha = alpha * kind(tau)
    return torch.from_numpy(out)


def armijo_search(merit_at: Callable, phi, D, alphas: torch.Tensor, eta: float):
    """Armijo backtracking over all trial steps at once.

    ``merit_at(alphas)`` gives the merit at ``x + alpha p`` for every trial
    step and lane, ``(n_bt, B)``, from one batched evaluation.  A lane takes
    the FIRST ``alpha`` with ``merit <= phi + eta * alpha * D`` -- the one
    the JAX package's scan keeps -- and ``1.0`` where none passes.
    ``alphas`` lie on the device of ``phi``.  Returns ``(ls_ok, alpha)``,
    both ``(B,)``."""
    ok = merit_at(alphas) <= phi + eta * alphas[:, None] * D
    steps = torch.arange(alphas.shape[0], device=phi.device)[:, None]
    first = torch.where(ok, steps, alphas.shape[0]).amin(0)
    ls_ok = ok.any(0)
    alpha = torch.where(ls_ok, alphas[torch.clamp_max(first, alphas.shape[0] - 1)], 1.0)
    return ls_ok, alpha


def make_ls_solver(
    nlp: NLP,
    params: Parameters = Parameters(algorithm="SQP-LS"),
    *,
    verbose: Optional[bool] = None,
) -> Callable[[NLPData], SqpResult]:
    """Build the batched SQP-LS solve function: batched :class:`NLPData` ->
    batched :class:`SqpResult` (``n_soc_accept`` counts the SOC steps;
    ``n_accept``, ``n_reject``, ``n_fr_iters`` are zero, as in the JAX
    package).  ``verbose`` (default ``params.OutputFlag``) prints the JAX
    package's header and iteration lines for a one-lane solve.  The line
    search has no structured path: ``kkt_structured`` only turns the Schur
    cap and the stall rescue off, as in the JAX package."""
    n, m = nlp.n, nlp.m
    n_lin = nlp.num_linear
    dtype = torch.float64 if params.dtype == "float64" else torch.float32
    exact_hessian = params.hessian_type == "exact"
    log_iters = bool(params.OutputFlag) if verbose is None else verbose
    mixed = params.kkt_precision.startswith("mixed")
    qp_tol_eff = max(params.qp_tol, 30.0 * float(torch.finfo(dtype).eps))
    polish = params.kkt_precision == "mixed_polish" and dtype == torch.float64
    if mixed and not polish:
        qp_tol_eff = max(qp_tol_eff, 2.0e-6)
    schur_cap = schur_cap_for(params, nlp)
    ipm_opts = IpmOptions(
        max_iter=params.qp_max_iter,
        tol=qp_tol_eff,
        ftb=params.qp_ftb,
        factor_dtype="float32" if mixed else "same",
        ir_steps=(
            max(4, params.kkt_ir_steps)
            if (params.kkt_precision == "mixed_plane" or schur_cap)
            else params.kkt_ir_steps
        ),
        kkt_backend=params.kkt_backend,
        plane=params.kkt_precision == "mixed_plane",
        # 20 = mixed_polish floor->tol phase; 8 = the stall rescue, which the
        # JAX line search keeps on whatever ``qp_rescue`` says
        polish_iters=(
            20 if polish
            else (8 if (mixed and not params.kkt_structured and dtype == torch.float64) else 0)
        ),
        invE_floor=3.0e-7 if schur_cap else 0.0,
        schur_cap=schur_cap,
    )
    w_big = params.elastic_weight
    eta = params.eta
    rho = params.rho
    max_iter = params.max_iter
    alphas = backtracking_alphas(params.tau, params.min_alpha, dtype)
    rough = qp_tol_eff**0.5
    solve_t0 = [0.0]

    def eval_all(x, lam, theta):
        f, df = nlp.obj_grad(x, theta)
        _, E = nlp.obj_cons(x, theta)
        J = nlp.cons_jac(x, theta)
        if exact_hessian:
            H = nlp.lag_hess(x, lam, theta)
        else:
            H = x.new_zeros((x.shape[0], n, n))
        return f, df, E, J, H

    def convexify(H):
        if not exact_hessian:
            return H
        eye = torch.eye(n, dtype=dtype, device=H.device)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        off = torch.sum(torch.abs(H), dim=-1) - torch.abs(diag)
        if params.hessian_shift == "ladder":
            # only the f32-factorability floor; the KKT delta ladder does the
            # inertia correction per interior-point iteration
            scale = 1.0 + amax0(torch.abs(diag) + off)
            return H + (4.0e-7 * scale)[:, None, None] * eye
        if params.hessian_shift == "gershgorin":
            lmin = torch.clamp_max(torch.amin(diag - off, dim=-1), 0.0)
        elif params.hessian_shift == "power":
            lmin = lanczos_lmin_bound(
                lambda v: mv(H, v), H.shape[0], n, dtype, H.device,
                iters=(params.hessian_shift_iters or min(n, 64)),
            )
        else:  # "eigh": float32 smallest eigenvalue, padded by f32 eps * |H|
            lmin32 = torch.linalg.eigvalsh(H.to(torch.float32))[:, 0]
            lmin = lmin32.to(dtype) - 4.0e-7 * amax0(torch.abs(H).flatten(-2))
        shift = torch.clamp_min(-lmin, 0.0) + torch.where(
            lmin < 1e-8, 1e-8 * (1.0 + torch.abs(lmin)), 0.0
        )
        return H + shift[:, None, None] * eye

    def adaptive_qp_tol(prim, dual):
        if params.qp_tol_adaptive <= 0.0:
            return None
        return torch.clamp(params.qp_tol_adaptive * torch.maximum(prim, dual), 0.0, 1.0e-3)

    def solve_subproblem(x, df, E, J, H_qp, fr, d: NLPData, skip, init, tol_override):
        rl = d.g_l - E
        ru = d.g_u - E
        v_lb = d.x_l - x
        v_ub = d.x_u - x
        lb = torch.clamp_min(v_lb, -_LS_TR)
        ub = torch.clamp_max(v_ub, _LS_TR)
        bad = lb > ub
        lb = torch.where(bad, torch.clamp_min(torch.clamp_max(v_lb, 0.0), -_LS_TR), lb)
        ub = torch.where(bad, torch.clamp_max(torch.clamp_min(v_ub, 0.0), _LS_TR), ub)
        is_linear_row = torch.arange(m, device=E.device) < n_lin
        freed = ((E < d.g_l) | (E > d.g_u)) & ~is_linear_row
        frc = fr[:, None]
        w = torch.where(frc & freed, 1.0, torch.full_like(E, w_big))
        Q = torch.where(fr[:, None, None], 0.0, H_qp)
        c = torch.where(frc, 0.0, df)
        sol = solve_qp(
            Q, c, J, rl, ru, lb, ub, w, opts=ipm_opts, skip=skip, init=init,
            tol_override=tol_override,
        )
        # drop step-box duals that belong to the fixed |p| <= 1000 box rather
        # than a true variable bound
        sol = sol._replace(
            mult_lo=torch.where(v_lb >= -_LS_TR, sol.mult_lo, 0.0),
            mult_up=torch.where(v_ub <= _LS_TR, sol.mult_up, 0.0),
        )
        hard = torch.where(frc, ~freed, True)
        hard_slack = amax0(torch.where(hard, sol.slack_u + sol.slack_v, 0.0))
        rough_exit = ~sol.converged & ((sol.pri_res > rough) | (sol.dual_res > rough))
        # slack mass certifies infeasibility only on a non-rough QP exit
        infeasible = (hard_slack > params.qp_infeas_tol) & ~rough_exit
        return sol, infeasible, rough_exit & ~infeasible

    def emit_log(st: LsState):
        """One iteration line of a one-lane solve, its values in one
        device-to-host transfer."""
        if not log_iters or st.x.shape[0] != 1:
            return
        vals = torch.stack([
            v[0].to(torch.float64) for v in (
                st.iter, st.fr, st.f, st.phi, amax0(st.mu), st.alpha, amax0(torch.abs(st.p)),
                st.prim_infeas, st.dual_infeas, st.compl,
            )
        ]).tolist()
        it, fr, f, phi, mu, al, pn, pr, du, co = vals
        mark = "FR" if fr else "  "
        print(
            f"{mark}{int(it):6d}  {f:+6.8e}  {phi:+6.8e}"
            f"  {mu:+6.8e}  {al:6.8e}  {pn:6.8e}"
            f"  {pr:6.8e}  {du:.8e}  {co:6.8e}"
            f"  {time.time() - solve_t0[0]:10.2f}"
        )

    def body(st: LsState, d: NLPData, trial_steps: torch.Tensor) -> LsState:
        theta = d.theta
        # LS evaluates every iteration (sqp_line_search.jl:118)
        f, df, E, J, H = eval_all(st.x, st.lam, theta)
        prim = norm_violations(E, d.g_l, d.g_u, st.x, d.x_l, d.x_u, ord=math.inf)
        dual = kt_residuals(df, st.lam, st.mult_up, st.mult_lo, J)
        compl = norm_complementarity(E, d.g_l, d.g_u, st.lam)
        st = st.replace(
            f=f, prim_infeas=prim, dual_infeas=dual, compl=compl, alpha=torch.zeros_like(f)
        )

        H_qp = convexify(H)
        # dual warm start: st.lam/mults are exactly the previous QP's duals;
        # the primal stays cold (x moved by alpha p)
        init = None
        if params.qp_warm_start:
            init = dict(
                p=torch.zeros_like(st.x), y=st.lam, zl=st.mult_lo, zu=st.mult_up,
                on=(st.iter > 1) & ~st.fr,
            )
        sol, qp_infeasible, qp_bad = solve_subproblem(
            st.x, df, E, J, H_qp, st.fr, d, skip=st.done, init=init,
            tol_override=adaptive_qp_tol(prim, dual),
        )
        failed = qp_infeasible | qp_bad
        fc = failed[:, None]
        p = torch.where(fc, 0.0, sol.p)
        # LS replaces multipliers outright (:127)
        lam = torch.where(fc, st.lam, sol.y)
        mlo = torch.where(fc, st.mult_lo, sol.mult_lo)
        mup = torch.where(fc, st.mult_up, sol.mult_up)
        st = st.replace(
            p=p, lam=lam, mult_lo=mlo, mult_up=mup,
            qp_iters_total=st.qp_iters_total + sol.iters,
        )
        live = ~st.done

        # triage (:137-160)
        fr_fail_ret = torch.where(
            prim <= params.tol_infeas,
            int(Status.FEASIBLE_POINT_FOUND),
            int(Status.INFEASIBLE_PROBLEM_DETECTED),
        ).to(torch.int32)
        set_ff = live & qp_infeasible & st.fr
        st = st.replace(ret=torch.where(set_ff, fr_fail_ret, st.ret), done=st.done | set_ff)
        live = ~st.done
        fr_enter = live & qp_infeasible & ~st.fr
        st = st.replace(fr=st.fr | fr_enter)
        bad_ret = torch.where(
            prim <= params.tol_infeas,
            int(Status.FEASIBLE_POINT_FOUND),
            int(Status.ERROR_IN_STEP_COMPUTATION),
        ).to(torch.int32)
        set_bad = live & qp_bad
        st = st.replace(ret=torch.where(set_bad, bad_ret, st.ret), done=st.done | set_bad)
        live = ~st.done
        live_step = live & ~fr_enter

        # penalty update rule 2 (:279-291)
        cv = constraint_violation(E, d.g_l, d.g_u)
        viol1 = torch.sum(cv, dim=-1) + _bound_viol(st.x, d)
        denom = torch.clamp_min((1.0 - rho) * viol1, 1e-8)
        hess_part = torch.clamp_min(0.5 * dot(p, mv(H, p)), 0.0)
        mu_init = ((dot(df, p) + hess_part) / denom)[:, None].expand(-1, m)
        mu_upd = torch.maximum(st.mu, torch.abs(lam))
        new_mu = select(st.iter == 1, mu_init, mu_upd)
        st = st.replace(mu=select(live_step, new_mu, st.mu))

        # merit and its directional derivative (merit.jl:13-17; sqp.jl:190-213)
        phi = ls_merit(f, E, st.x, st.mu, st.fr, d)
        slack_mass = torch.sum(
            torch.where(st.fr[:, None], sol.slack_u + sol.slack_v, 0.0), dim=-1
        )
        dfp = torch.where(st.fr, slack_mass, dot(df, p))
        mu_eff = torch.where(st.fr[:, None], 1.0, st.mu)
        D = merit_derivative(dfp, mu_eff, cv)
        st = st.replace(phi=torch.where(live_step, phi, st.phi))

        # Armijo backtracking (compute_alpha, :303-334) over every trial step
        # at once: (n_bt, B, n) trial points, one batched evaluation
        def merit_at(al):
            k, B = al.shape[0], st.x.shape[0]
            x_t = st.x[None] + al[:, None, None] * p[None]
            th = None if theta is None else map_lanes(
                lambda t: t.repeat((k,) + (1,) * (t.dim() - 1)), theta
            )
            f_t, E_t = nlp.obj_cons(x_t.reshape(k * B, n), th)
            return ls_merit(f_t.reshape(k, B), E_t.reshape(k, B, m), x_t, st.mu, st.fr, d)

        ls_ok, alpha_best = armijo_search(merit_at, phi, D, trial_steps, eta)
        tiny_dir = amax0(torch.abs(p)) <= params.tol_direction
        ls_ok = ls_ok | tiny_dir  # (:307-309)
        alpha = torch.where(tiny_dir, 1.0, alpha_best)
        st = st.replace(alpha=torch.where(live_step, alpha, st.alpha))

        emit_log(st)

        # convergence (:172-192)
        tiny_live = live_step & tiny_dir
        fr_tiny = tiny_live & st.fr
        fr_stuck = fr_tiny & (prim > params.tol_infeas)
        conv_tiny = tiny_live & ~st.fr
        st = st.replace(
            fr=st.fr & ~fr_tiny,
            ret=torch.where(
                conv_tiny,
                int(Status.SOLVE_SUCCEEDED),
                torch.where(fr_stuck, int(Status.INFEASIBLE_PROBLEM_DETECTED), st.ret),
            ).to(torch.int32),
            done=st.done | conv_tiny | fr_stuck,
        )
        live_step = live_step & ~tiny_dir

        near_feas = (prim <= params.tol_infeas) & (compl <= params.tol_residual)
        fr_exit2 = live_step & near_feas & st.fr
        conv_kkt = live_step & near_feas & ~st.fr & (dual <= params.tol_residual)
        st = st.replace(
            fr=st.fr & ~fr_exit2,
            ret=torch.where(conv_kkt, int(Status.SOLVE_SUCCEEDED), st.ret),
            done=st.done | conv_kkt,
        )
        live_step = live_step & ~conv_kkt & ~fr_exit2

        # SOC on line-search failure (:210-223), whatever use_soc says; its
        # solution is the whole corrected step, taken instead of alpha p
        x_p = st.x + p
        _, E_p = nlp.obj_cons(x_p, theta)
        E_soc = E_p - mv(J, p)
        lb = torch.clamp_min(d.x_l - st.x, -_LS_TR)
        ub = torch.clamp_max(d.x_u - st.x, _LS_TR)
        need_soc = live_step & ~ls_ok
        soc_init = None
        if params.qp_warm_start:
            soc_init = dict(p=p, y=lam, zl=mlo, zu=mup, on=need_soc)
        soc_sol = solve_qp(
            H_qp, df, J, d.g_l - E_soc, d.g_u - E_soc, lb, ub, torch.full_like(E, w_big),
            opts=ipm_opts, skip=~need_soc, init=soc_init,
        )
        soc = torch.where(need_soc[:, None], soc_sol.p, 0.0)
        alpha = torch.where(need_soc, 0.0, alpha)
        st = st.replace(
            n_soc=st.n_soc + need_soc.to(torch.int32),
            qp_iters_total=st.qp_iters_total + torch.where(need_soc, soc_sol.iters, 0),
        )
        new_x = st.x + alpha[:, None] * p + soc
        st = st.replace(x=select(live_step, new_x, st.x))
        return st.replace(iter=st.iter + live.to(torch.int32))

    def init_state(d: NLPData) -> LsState:
        x0 = initial_point(d)
        B, dev = x0.shape[0], x0.device
        f0, _ = nlp.obj_cons(x0, d.theta)
        nan_f = ~torch.isfinite(f0)

        def full(val, dt=dtype):
            return torch.full((B,), val, dtype=dt, device=dev)

        i32 = torch.int32
        return LsState(
            x=x0,
            lam=x0.new_zeros((B, m)),
            mult_lo=x0.new_zeros((B, n)),
            mult_up=x0.new_zeros((B, n)),
            mu=torch.full((B, m), 10.0, dtype=dtype, device=dev),  # sqp_line_search.jl:47
            f=f0,
            prim_infeas=full(torch.inf),
            dual_infeas=full(torch.inf),
            compl=full(torch.inf),
            p=x0.new_zeros((B, n)),
            phi=full(torch.inf),
            alpha=full(1.0),
            fr=full(False, torch.bool),
            iter=full(1, i32),
            ret=torch.where(
                nan_f, int(Status.INVALID_NUMBER_DETECTED), int(Status.OPTIMIZE_NOT_CALLED)
            ).to(i32),
            done=nan_f,
            qp_iters_total=full(0, i32),
            n_soc=full(0, i32),
        )

    def run(d: NLPData) -> SqpResult:
        st = init_state(d)
        trial_steps = alphas.to(d.x0.device)
        while True:
            active = ~st.done & (st.iter <= max_iter)
            if not any_lane(active):
                break
            st = map_lanes(lambda a, b: select(active, a, b), body(st, d, trial_steps), st)
        limit_ret = torch.where(
            st.prim_infeas <= params.tol_infeas,
            int(Status.FEASIBLE_POINT_FOUND),
            int(Status.MAXIMUM_ITERATIONS_EXCEEDED),
        ).to(torch.int32)
        obj_val, g_out = nlp.obj_cons(st.x, d.theta)
        zeros = torch.zeros_like(st.iter)
        return SqpResult(
            x=st.x,
            obj_val=-obj_val if nlp.maximize else obj_val,
            status=torch.where(~st.done, limit_ret, st.ret),
            g=g_out,
            mult_g=st.lam,
            mult_x_L=st.mult_lo,
            mult_x_U=st.mult_up,
            iterations=st.iter,
            prim_infeas=st.prim_infeas,
            dual_infeas=st.dual_infeas,
            qp_iters_total=st.qp_iters_total,
            n_accept=zeros,
            n_reject=zeros,
            n_soc_accept=st.n_soc,
            n_fr_iters=zeros,
        )

    def solve(d: NLPData) -> SqpResult:
        solve_t0[0] = time.time()
        if log_iters and d.x0.shape[0] == 1:
            print(
                f"  {'iter':>6}  {'f(x_k)':>15}  {'phi(x_k)':>15}  {'|mu|':>15}"
                f"  {'alpha':>14}  {'|p|':>14}  {'inf_pr':>14}  {'inf_du':>14}"
                f"  {'compl':>14}  {'time':>10}"
            )
        with true_float32_matmul():
            return run(d)

    return solve
