"""Presolve warm start: solve once cheaply, start the strict solve there
(torch port of the JAX package's ``utils/warmstart.py``).

The analog of the reference's Ipopt-presolve initialization
(``examples/acopf/init_opf.jl:25-47`` of the reference: a second copy of the
model is optimized and its solution copied into the start values).  Here the
presolver is the package itself at a loose tolerance, on the same batch and
device as the strict solve, and both the primal start ``x0`` and the dual
start ``lam0`` carry over.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nlp import NLP, NLPData
from ..parameters import Parameters

_PRESOLVE_OVERRIDES = dict(
    tol_infeas=1.0e-4,
    tol_residual=1.0e-2,
    tol_direction=1.0e-4,
    OutputFlag=0,
)


def presolve_parameters(params: Parameters, **overrides) -> Parameters:
    """Loose-tolerance copy of ``params`` used for the presolve pass."""
    kw = dict(_PRESOLVE_OVERRIDES)
    kw.setdefault("max_iter", min(params.max_iter, 50))
    kw.update(overrides)
    return dataclasses.replace(params, **kw)


def presolve_start(
    nlp: NLP,
    params: Parameters = Parameters(),
    data: NLPData | None = None,
    presolve_params: Parameters | None = None,
    *,
    device=None,
    **overrides,
) -> NLPData:
    """Run a loose presolve and return ``data`` with ``x0`` / ``lam0`` set to
    the presolve solution (``x`` clamped into the variable box).

    ``data`` is batched (a leading lane axis, ``parallel.batch.batch_data``);
    ``None`` means one lane of the NLP's own data on ``device`` (``None``:
    the CUDA card).  The presolve runs as one batched solve where the data
    lies.
    """
    from .. import make_solver
    from ..parallel.batch import batch_data

    pp = presolve_params or presolve_parameters(params, **overrides)
    if data is None:
        dtype = torch.float64 if pp.dtype == "float64" else torch.float32
        data = batch_data(nlp, 1, dtype=dtype, device=device)
    raw = make_solver(nlp, pp, verbose=False)(data)
    x0 = torch.clamp(raw.x, min=data.x_l, max=data.x_u)
    return dataclasses.replace(data, x0=x0, lam0=raw.mult_g)
