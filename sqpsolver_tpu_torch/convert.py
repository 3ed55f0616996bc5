"""Moving problem data and results between the JAX package and this port.

In this system the problem data (bounds, start points, scenario loads) plays
the part that weights play in a model: both packages must compute on the
same numbers.  The functions here take plain arrays (anything
``numpy.asarray`` accepts, e.g. the JAX package's ``NLPData`` fields) and
return this package's tensors, and turn results back into numpy arrays.
:func:`sqp_state_to_torch` does the same for the solver state in the middle
of a solve, so that both packages can be started from one point and a round
of ``run_until`` compared field by field.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .algorithms.sqp_tr import SqpState
from .nlp import NLPData, resolve_device


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def nlp_data_to_torch(data, *, device=None, dtype=torch.float64) -> NLPData:
    """An object with ``x_l``, ``x_u``, ``g_l``, ``g_u``, ``x0`` (and optional
    ``theta`` dict and ``lam0``) of arrays -> :class:`NLPData` of tensors on
    ``device`` (``None``: the CUDA card; ``"cpu"`` must be asked for) in
    ``dtype``.  Leading batch axes carry over unchanged."""
    device = resolve_device(device)
    theta = getattr(data, "theta", None)
    lam0 = getattr(data, "lam0", None)
    return NLPData(
        x_l=_tensor(data.x_l, dtype, device),
        x_u=_tensor(data.x_u, dtype, device),
        g_l=_tensor(data.g_l, dtype, device),
        g_u=_tensor(data.g_u, dtype, device),
        x0=_tensor(data.x0, dtype, device),
        theta=None if theta is None else theta_to_torch(theta, device=device, dtype=dtype),
        lam0=None if lam0 is None else _tensor(lam0, dtype, device),
    )


def theta_to_torch(theta: dict, *, device=None, dtype=torch.float64) -> dict:
    """A scenario-parameter dict of arrays -> dict of tensors on ``device``
    (``None``: the CUDA card)."""
    device = resolve_device(device)
    return {k: _tensor(v, dtype, device) for k, v in theta.items()}


def sqp_state_to_torch(state, *, device=None, dtype=torch.float64) -> SqpState:
    """A batched solver state of arrays (the JAX package's ``SqpState``, or
    any object with its fields) -> this package's :class:`SqpState` on
    ``device`` (``None``: the CUDA card).  Floating fields go to ``dtype``,
    flags to bool and counters to int32, the per-iteration ``stats`` (a dict
    of arrays, or ``None``) likewise."""
    device = resolve_device(device)

    def conv(a):
        a = np.array(a)
        if a.dtype == np.bool_:
            kind = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            kind = torch.int32
        else:
            kind = dtype
        return torch.as_tensor(a, dtype=kind, device=device)

    out = {}
    for f in dataclasses.fields(SqpState):
        val = getattr(state, f.name)
        if f.name == "stats":
            out[f.name] = None if val is None else {k: conv(v) for k, v in val.items()}
        else:
            out[f.name] = conv(val)
    return SqpState(**out)


def sqp_state_to_numpy(state: SqpState) -> dict:
    """This package's :class:`SqpState` -> dict of numpy arrays by field
    (``stats``: a dict of arrays, or ``None``)."""

    def host(t):
        return t.detach().cpu().numpy()

    out = {}
    for f in dataclasses.fields(SqpState):
        val = getattr(state, f.name)
        if f.name == "stats":
            out[f.name] = None if val is None else {k: host(v) for k, v in val.items()}
        else:
            out[f.name] = host(val)
    return out


def result_to_numpy(result) -> dict:
    """A result NamedTuple (this package's ``SqpResult``, or the JAX
    package's) -> dict of numpy arrays; ``None`` fields are dropped."""
    out = {}
    for key, val in result._asdict().items():
        if val is None or isinstance(val, dict):
            continue
        if torch.is_tensor(val):
            val = val.detach().cpu().numpy()
        out[key] = np.asarray(val)
    return out
