"""KKT / violation formulas (torch port of ``algorithms/common.py``).

Every function reduces over the LAST axis, so it serves one instance or a
batch with a leading instance axis alike.  Multiplier sign convention, as in
the JAX package: stationarity is ``grad f + J^T lam + nu_U - nu_L = 0``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._lanes import amax0, dot, mv


def lanczos_start(n: int, dtype, device) -> torch.Tensor:
    """The deterministic unit Gaussian start vector of
    :func:`lanczos_lmin_bound`, ``(n,)``: a Gaussian overlaps every
    eigenvector by ~1/sqrt(n) with high probability.  The JAX package draws
    its own from ``jax.random``; the numbers differ, the role does not."""
    v0 = np.random.default_rng(20240819).standard_normal(n)
    return torch.as_tensor(v0 / np.linalg.norm(v0), dtype=dtype, device=device)


def lanczos_lmin_bound(h_mv, batch: int, n: int, dtype, device, iters: int = 40, v0=None):
    """Lower bound on ``lambda_min`` of a batch of symmetric operators via
    Lanczos, ``(batch,)``.

    ``h_mv`` maps ``(batch, n)`` to ``(batch, n)``.  Runs ``iters`` Lanczos
    steps (matvecs only), takes the smallest Ritz value of each lane's
    tridiagonal matrix and subtracts the residual term ``beta_k |s_k|`` (the
    Kaniel-Paige bound), a valid lower bound even before convergence.  Every
    lane starts from the same vector ``v0`` (default :func:`lanczos_start`).
    A breakdown (``beta`` = 0 on a lane: its Krylov space is exhausted) is
    handled per lane as the JAX package does: the next vector is ``w /
    max(beta, 1e-30)``, i.e. zero, and the later steps add zero rows to that
    lane's tridiagonal matrix.
    """
    if v0 is None:
        v0 = lanczos_start(n, dtype, device)
    v = v0.to(dtype=dtype, device=device).expand(batch, n)
    v_prev = torch.zeros((batch, n), dtype=dtype, device=device)
    beta_prev = torch.zeros((batch,), dtype=dtype, device=device)
    alphas, betas = [], []
    for _ in range(iters):
        w = h_mv(v) - beta_prev[:, None] * v_prev
        alpha = dot(v, w)
        w = w - alpha[:, None] * v
        # one extra projection against the previous two vectors curbs the
        # worst drift (full reorthogonalization is overkill)
        w = w - dot(w, v)[:, None] * v - dot(w, v_prev)[:, None] * v_prev
        beta = torch.linalg.vector_norm(w, dim=-1)
        v_prev, v, beta_prev = v, w / torch.clamp_min(beta, 1e-30)[:, None], beta
        alphas.append(alpha)
        betas.append(beta)
    alphas = torch.stack(alphas, dim=-1)
    betas = torch.stack(betas, dim=-1)
    T = (
        torch.diag_embed(alphas)
        + torch.diag_embed(betas[:, :-1], offset=1)
        + torch.diag_embed(betas[:, :-1], offset=-1)
    )
    # float32 is ample for the tiny (iters x iters) eigenproblem; its ~1e-5
    # relative cost on the bound is absorbed by the pad
    evals, evecs = torch.linalg.eigh(T.to(torch.float32))
    idx = torch.argmin(evals, dim=-1)
    theta = torch.gather(evals, -1, idx[:, None])[:, 0].to(dtype)
    last = torch.gather(evecs[:, -1, :], -1, idx[:, None])[:, 0]
    resid = betas[:, -1] * torch.abs(last).to(dtype)
    pad = 4.0e-7 * amax0(torch.abs(alphas) + 2.0 * betas)
    return theta - resid - pad


def constraint_violation(E, g_l, g_u):
    """Per-row constraint violation max(E - g_u, g_l - E, 0)."""
    return torch.clamp_min(torch.maximum(E - g_u, g_l - E), 0.0)


def bound_violation(x, x_l, x_u):
    """Per-variable bound violation."""
    return torch.clamp_min(torch.maximum(x - x_u, x_l - x), 0.0)


def norm_violations(E, g_l, g_u, x, x_l, x_u, ord=math.inf):
    """p-norm of stacked constraint + bound violations (the SQP loop uses
    ord=1)."""
    viol = torch.cat(
        [constraint_violation(E, g_l, g_u), bound_violation(x, x_l, x_u)], dim=-1
    )
    if ord == 1:
        return viol.sum(-1)
    if ord == math.inf:
        return amax0(viol)
    return torch.linalg.vector_norm(viol, ord=ord, dim=-1)


def kt_residuals_from_parts(df, lam, mult_x_U, mult_x_L, jt_lam, row_norms):
    """:func:`kt_residuals` from precomputed ``J^T lam`` and row norms."""
    stat = df + jt_lam + mult_x_U - mult_x_L
    res = amax0(torch.abs(stat))
    scalar = torch.clamp_min(amax0(torch.abs(df)), 1.0)
    scalar = torch.maximum(scalar, amax0(torch.abs(mult_x_U)))
    scalar = torch.maximum(scalar, amax0(torch.abs(mult_x_L)))
    scalar = torch.maximum(scalar, amax0(torch.abs(lam) * row_norms))
    return res / scalar


def kt_residuals(df, lam, mult_x_U, mult_x_L, jac):
    """Normalized Kuhn-Tucker residual

        || df + J^T lam + nu_U - nu_L ||_inf
        -------------------------------------------------------------
        max(1, ||df||_inf, ||nu_U||_inf, ||nu_L||_inf, max_i |lam_i| * ||J_i||_2)
    """
    row_norms = torch.sqrt(torch.sum(jac * jac, dim=-1))
    return kt_residuals_from_parts(
        df, lam, mult_x_U, mult_x_L, mv(jac.transpose(-1, -2), lam), row_norms
    )


def norm_complementarity(E, g_l, g_u, lam):
    """Normalized complementarity (the reference's ``common.jl:30-47``),
    infinity norm: equality rows contribute zero; inequality rows contribute
    ``min(E - g_l, g_u - E) * lam``, normalized by ``1 + ||lam_ineq||_2``."""
    is_eq = g_l == g_u
    compl = torch.where(is_eq, 0.0, torch.minimum(E - g_l, g_u - E) * lam)
    denom = torch.sqrt(torch.sum(torch.where(is_eq, 0.0, lam * lam), dim=-1))
    return amax0(torch.abs(compl)) / (1.0 + denom)


def schur_cap_for(params, nlp) -> int:
    """Resolve Parameters.schur_cap into a concrete IpmOptions.schur_cap:
    the static equality count plus headroom for active inequalities (at
    least 32 rows, at least a quarter of the inequality rows), rounded up to
    a multiple of 8, and only where that keeps at most 3/4 of the rows.
    Dense float32-factorized modes only."""
    m = nlp.m
    if (
        params.schur_cap == 0
        or params.kkt_structured
        or not params.kkt_precision.startswith("mixed")
        or m == 0
    ):
        return 0
    if params.schur_cap > 0:
        return min(params.schur_cap, m)
    m_eq = int(
        np.sum(
            np.broadcast_to(np.asarray(nlp.g_l), (m,))
            == np.broadcast_to(np.asarray(nlp.g_u), (m,))
        )
    )
    cap = m_eq + max(32, (m - m_eq + 3) // 4)
    cap = min(m, ((cap + 7) // 8) * 8)
    return cap if cap <= int(0.75 * m) else 0
