"""Merit-function directional derivative (torch port of the JAX package's
``algorithms/merit.py``).

Parity with the reference's ``src/algorithms/merit.jl:13-17``: the
directional derivative of the l1 exact-penalty merit at x along p,

    D(phi; p) = grad f' p - mu . viol(x)

in both the scalar-penalty (SQP-TR) and per-constraint vector-penalty
(SQP-LS) forms; the feasibility-restoration variant replaces grad f' p with
the slack mass (sqp.jl:190-213).  Batched: the sum runs over the last axis.
"""

from __future__ import annotations

import torch


def merit_derivative(dfp: torch.Tensor, mu, cons_viol: torch.Tensor) -> torch.Tensor:
    """D = dfp - mu . viol  (``mu`` a number, a per-lane scalar ``(B,)`` or a
    per-row vector ``(B, m)``; ``cons_viol`` is ``(B, m)``)."""
    if torch.is_tensor(mu) and mu.dim() == cons_viol.dim() - 1:
        mu = mu.unsqueeze(-1)
    return dfp - torch.sum(mu * cons_viol, dim=-1)
