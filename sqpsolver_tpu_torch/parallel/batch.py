"""Instance-batched solves (torch port of ``parallel/batch.py``).

The port's solver is batch-first already: one host-driven SQP program
advances B independent instances in lockstep, with per-instance status, FR
and TR state as masked arithmetic; the batch finishes when every instance
has terminated.  The chunked solver of the JAX package is not ported yet
(ROADMAP, later-PR list item 6).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..algorithms.sqp_tr import SqpResult, make_solver
from ..convert import theta_to_torch
from ..nlp import NLP, NLPData, resolve_device
from ..parameters import Parameters


def batch_data(
    nlp: NLP,
    batch: int,
    *,
    theta=None,
    x0=None,
    dtype=torch.float64,
    device=None,
) -> NLPData:
    """Tile an NLP's data along a leading batch axis on ``device``.

    ``device=None`` is the CUDA card, and raises where there is none; the CPU
    is used only when asked for (``device="cpu"``).  The solver runs where
    the data lies.  ``theta`` (a dict of arrays with leading axis ``batch``)
    and/or ``x0`` (per-instance starts, (batch, n)) override the tiled
    defaults.
    """
    device = resolve_device(device)
    base = nlp.data(dtype=dtype, device=device)

    def tile(a):
        return a.expand((batch,) + tuple(a.shape)).clone()

    if theta is None:
        theta = None if base.theta is None else {k: tile(v) for k, v in base.theta.items()}
    else:
        theta = theta_to_torch(theta, device=device, dtype=dtype)
    x0_t = tile(base.x0) if x0 is None else torch.as_tensor(x0, dtype=dtype, device=device)
    return NLPData(
        x_l=tile(base.x_l),
        x_u=tile(base.x_u),
        g_l=tile(base.g_l),
        g_u=tile(base.g_u),
        x0=x0_t,
        theta=theta,
    )


def make_batch_solver(
    nlp: NLP, params: Parameters = Parameters()
) -> Callable[[NLPData], SqpResult]:
    """Batched solver: batched NLPData -> batched SqpResult, on the device
    the data lies on."""
    return make_solver(nlp, params)


def summarize_batch(raw: SqpResult) -> dict:
    """Host-side summary of a batched solve."""

    def host(t):
        return t.detach().cpu().numpy()

    status = host(raw.status)
    return {
        "batch": int(status.shape[0]),
        "n_success": int(np.isin(status, [0, 1, 6]).sum()),
        "n_infeasible": int((status == 2).sum()),
        "status_counts": {int(s): int((status == s).sum()) for s in np.unique(status)},
        "iterations_max": int(host(raw.iterations).max()),
        "iterations_mean": float(host(raw.iterations).mean()),
        "prim_infeas_max": float(host(raw.prim_infeas).max()),
        "obj_mean": float(host(raw.obj_val).mean()),
        "n_reject": int(host(raw.n_reject).sum()),
        "n_fr": int(host(raw.n_fr_iters).sum()),
        "n_soc": int(host(raw.n_soc_accept).sum()),
        "qp_trips": int(host(raw.qp_iters_total).sum()),
    }
