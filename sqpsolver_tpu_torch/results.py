"""Host-side result wrapper (torch port of the JAX package's ``results.py``).

Plays the role of the reference's MOI result getters
(``src/MOI_wrapper.jl:1232-1453`` of the reference): termination status,
objective value with max-sense un-scaling, primal/dual values, solve time.

Multiplier conventions of the reported values (Ipopt-style, matching the
reference's write-back sign flips at ``sqp_trust_region.jl:215-222``):
``mult_g[i] > 0`` when row i's upper side is active, ``mult_x_L/U >= 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .status import Status, is_success, status_name


@dataclasses.dataclass
class Results:
    """Solution of one NLP solve."""

    x: np.ndarray
    obj_val: float
    status: Status
    g: np.ndarray
    mult_g: np.ndarray
    mult_x_L: np.ndarray
    mult_x_U: np.ndarray
    iterations: int
    prim_infeas: float
    dual_infeas: float
    solve_time: float
    qp_iters_total: int
    n_accept: int
    n_reject: int
    n_soc_accept: int
    n_fr_iters: int
    statistics: Any = None

    @property
    def status_name(self) -> str:
        return status_name(self.status)

    @property
    def success(self) -> bool:
        return is_success(self.status)

    def __repr__(self) -> str:
        return (
            f"Results(status={self.status_name}, obj={self.obj_val:.8e}, "
            f"iter={self.iterations}, inf_pr={self.prim_infeas:.2e}, "
            f"inf_du={self.dual_infeas:.2e}, time={self.solve_time:.3f}s)"
        )


def from_raw(raw, solve_time: float, lane: int = 0) -> Results:
    """Lane ``lane`` of a batched ``SqpResult`` (tensors with the lanes on
    their leading axis, on any device) as host-side :class:`Results`; the
    per-iteration statistics keep their first ``iterations + 1`` rows."""

    def host(t):
        return t[lane].detach().cpu().numpy()

    n_it = int(host(raw.iterations))
    stats = raw.stats
    if stats is not None:
        stats = {k: host(v)[: n_it + 1] for k, v in stats.items()}
    try:
        status = Status(int(host(raw.status)))
    except ValueError:
        status = Status.INTERNAL_ERROR
    return Results(
        x=host(raw.x),
        obj_val=float(host(raw.obj_val)),
        status=status,
        g=host(raw.g),
        mult_g=host(raw.mult_g),
        mult_x_L=host(raw.mult_x_L),
        mult_x_U=host(raw.mult_x_U),
        iterations=n_it,
        prim_infeas=float(host(raw.prim_infeas)),
        dual_infeas=float(host(raw.dual_infeas)),
        solve_time=solve_time,
        qp_iters_total=int(host(raw.qp_iters_total)),
        n_accept=int(host(raw.n_accept)),
        n_reject=int(host(raw.n_reject)),
        n_soc_accept=int(host(raw.n_soc_accept)),
        n_fr_iters=int(host(raw.n_fr_iters)),
        statistics=stats,
    )
