"""Hock–Schittkowski test problems as torch NLPs (port of the JAX package's
``models/hs.py``, expression by expression).

The reference's correctness battery is the upstream MOI conformance suite
(the reference's ``test/MOI_wrapper.jl:36-63``) — meaningless without MOI.
Per SURVEY §4 (implications item b) the replacement battery is this classic
NLP test set: each problem is stated exactly as in Hock & Schittkowski,
"Test Examples for Nonlinear Programming Codes" (1981), with the published
optimal objective value ``f_star`` (and ``x_star`` where unique) as the golden
target, and the book's standard starting points.

Constraint rows are ordered *linear first* with ``num_linear`` set, matching
the framework's canonical ordering (reference MOI_wrapper.jl:750-766).

Every function is written in torch ops that ``torch.func`` (``vmap``,
``jacfwd``, ``hessian``) can take, with no Python branch on tensor values;
constants of the book (``sqrt(3)``, ``pi``) are Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import math

import numpy as np
import torch

from ..nlp import NLP

INF = np.inf


@dataclasses.dataclass(frozen=True)
class HSProblem:
    nlp: NLP
    f_star: float
    x_star: Optional[np.ndarray] = None


_REGISTRY: dict[str, HSProblem] = {}


def _register(name, f_star, x_star=None, **nlp_kw):
    nlp = NLP(name=name, **nlp_kw)
    _REGISTRY[name] = HSProblem(
        nlp=nlp,
        f_star=f_star,
        x_star=None if x_star is None else np.asarray(x_star, float),
    )


def hs_problem(name: str) -> HSProblem:
    return _REGISTRY[name]


def hs_names() -> list[str]:
    return sorted(_REGISTRY)


def _bounds(n, lo=-INF, hi=INF):
    return np.full(n, lo, float), np.full(n, hi, float)


# --- bound-constrained -----------------------------------------------------

_register(
    "hs001",
    f_star=0.0,
    x_star=[1.0, 1.0],
    f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
    g=None,
    n=2,
    m=0,
    x_l=np.array([-INF, -1.5]),
    x_u=np.array([INF, INF]),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.array([-2.0, 1.0]),
)

_register(
    "hs003",
    f_star=0.0,
    x_star=[0.0, 0.0],
    f=lambda x: x[1] + 1.0e-5 * (x[1] - x[0]) ** 2,
    g=None,
    n=2,
    m=0,
    x_l=np.array([-INF, 0.0]),
    x_u=np.array([INF, INF]),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.array([10.0, 1.0]),
)

_register(
    "hs004",
    f_star=8.0 / 3.0,
    x_star=[1.0, 0.0],
    f=lambda x: (x[0] + 1.0) ** 3 / 3.0 + x[1],
    g=None,
    n=2,
    m=0,
    x_l=np.array([1.0, 0.0]),
    x_u=np.array([INF, INF]),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.array([1.125, 0.125]),
)

_register(
    "hs005",
    f_star=-(np.sqrt(3.0) / 2.0 + np.pi / 3.0),
    f=lambda x: (
        torch.sin(x[0] + x[1])
        + (x[0] - x[1]) ** 2
        - 1.5 * x[0]
        + 2.5 * x[1]
        + 1.0
    ),
    g=None,
    n=2,
    m=0,
    x_l=np.array([-1.5, -3.0]),
    x_u=np.array([4.0, 3.0]),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.array([0.0, 0.0]),
)

# --- nonlinear equality ----------------------------------------------------

_register(
    "hs006",
    f_star=0.0,
    x_star=[1.0, 1.0],
    f=lambda x: (1.0 - x[0]) ** 2,
    g=lambda x: torch.stack([10.0 * (x[1] - x[0] ** 2)]),
    n=2,
    m=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0]),
    g_u=np.array([0.0]),
    x0=np.array([-1.2, 1.0]),
)

_register(
    "hs007",
    f_star=-np.sqrt(3.0),
    x_star=[0.0, np.sqrt(3.0)],
    f=lambda x: torch.log(1.0 + x[0] ** 2) - x[1],
    g=lambda x: torch.stack([(1.0 + x[0] ** 2) ** 2 + x[1] ** 2 - 4.0]),
    n=2,
    m=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0]),
    g_u=np.array([0.0]),
    x0=np.array([2.0, 2.0]),
)

_register(
    "hs008",
    f_star=-1.0,
    f=lambda x: x.new_tensor(-1.0),
    g=lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - 25.0, x[0] * x[1] - 9.0]),
    n=2,
    m=2,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.array([2.0, 1.0]),
)

_register(
    "hs009",
    f_star=-0.5,
    f=lambda x: torch.sin(np.pi * x[0] / 12.0) * torch.cos(np.pi * x[1] / 16.0),
    g=lambda x: torch.stack([4.0 * x[0] - 3.0 * x[1]]),  # linear
    n=2,
    m=1,
    num_linear=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0]),
    g_u=np.array([0.0]),
    x0=np.array([0.0, 0.0]),
)

# --- nonlinear inequality --------------------------------------------------

_register(
    "hs010",
    f_star=-1.0,
    x_star=[0.0, 1.0],
    f=lambda x: x[0] - x[1],
    g=lambda x: torch.stack(
        [-3.0 * x[0] ** 2 + 2.0 * x[0] * x[1] - x[1] ** 2 + 1.0]
    ),
    n=2,
    m=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0]),
    g_u=np.array([INF]),
    x0=np.array([-10.0, 10.0]),
)

_register(
    "hs011",
    f_star=-8.498464223,
    f=lambda x: (x[0] - 5.0) ** 2 + x[1] ** 2 - 25.0,
    g=lambda x: torch.stack([-(x[0] ** 2) + x[1]]),
    n=2,
    m=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0]),
    g_u=np.array([INF]),
    x0=np.array([4.9, 0.1]),
)

_register(
    "hs012",
    f_star=-30.0,
    x_star=[2.0, 3.0],
    f=lambda x: 0.5 * x[0] ** 2 + x[1] ** 2 - x[0] * x[1] - 7.0 * x[0] - 7.0 * x[1],
    g=lambda x: torch.stack([25.0 - 4.0 * x[0] ** 2 - x[1] ** 2]),
    n=2,
    m=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0]),
    g_u=np.array([INF]),
    x0=np.array([0.0, 0.0]),
)

_register(
    "hs014",
    f_star=9.0 - 2.875 * np.sqrt(7.0),
    f=lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2,
    # linear equality first, then the nonlinear inequality
    g=lambda x: torch.stack(
        [
            x[0] - 2.0 * x[1] + 1.0,
            -0.25 * x[0] ** 2 - x[1] ** 2 + 1.0,
        ]
    ),
    n=2,
    m=2,
    num_linear=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.array([0.0, 0.0]),
    g_u=np.array([0.0, INF]),
    x0=np.array([2.0, 2.0]),
)

_register(
    "hs015",
    f_star=306.5,
    x_star=[0.5, 2.0],
    f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
    g=lambda x: torch.stack([x[0] * x[1] - 1.0, x[0] + x[1] ** 2]),
    n=2,
    m=2,
    x_l=np.array([-INF, -INF]),
    x_u=np.array([0.5, INF]),
    g_l=np.array([0.0, 0.0]),
    g_u=np.array([INF, INF]),
    x0=np.array([-2.0, 1.0]),
)

_register(
    "hs016",
    f_star=0.25,
    x_star=[0.5, 0.25],
    f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
    g=lambda x: torch.stack([x[0] + x[1] ** 2, x[0] ** 2 + x[1]]),
    n=2,
    m=2,
    x_l=np.array([-0.5, -INF]),
    x_u=np.array([0.5, 1.0]),
    g_l=np.array([0.0, 0.0]),
    g_u=np.array([INF, INF]),
    x0=np.array([-2.0, 1.0]),
)

_register(
    "hs018",
    f_star=5.0,
    f=lambda x: 0.01 * x[0] ** 2 + x[1] ** 2,
    g=lambda x: torch.stack(
        [x[0] * x[1] - 25.0, x[0] ** 2 + x[1] ** 2 - 25.0]
    ),
    n=2,
    m=2,
    x_l=np.array([2.0, 0.0]),
    x_u=np.array([50.0, 50.0]),
    g_l=np.array([0.0, 0.0]),
    g_u=np.array([INF, INF]),
    x0=np.array([2.0, 2.0]),
)

_register(
    "hs021",
    f_star=-99.96,
    x_star=[2.0, 0.0],
    f=lambda x: 0.01 * x[0] ** 2 + x[1] ** 2 - 100.0,
    g=lambda x: torch.stack([10.0 * x[0] - x[1]]),  # linear
    n=2,
    m=1,
    num_linear=1,
    x_l=np.array([2.0, -50.0]),
    x_u=np.array([50.0, 50.0]),
    g_l=np.array([10.0]),
    g_u=np.array([INF]),
    x0=np.array([-1.0, -1.0]),
)

_register(
    "hs028",
    f_star=0.0,
    x_star=[0.5, -0.5, 0.5],
    f=lambda x: (x[0] + x[1]) ** 2 + (x[1] + x[2]) ** 2,
    g=lambda x: torch.stack([x[0] + 2.0 * x[1] + 3.0 * x[2] - 1.0]),  # linear
    n=3,
    m=1,
    num_linear=1,
    x_l=_bounds(3)[0],
    x_u=_bounds(3)[1],
    g_l=np.array([0.0]),
    g_u=np.array([0.0]),
    x0=np.array([-4.0, 1.0, 1.0]),
)

_register(
    "hs033",
    f_star=np.sqrt(2.0) - 6.0,
    f=lambda x: (x[0] - 1.0) * (x[0] - 2.0) * (x[0] - 3.0) + x[2],
    g=lambda x: torch.stack(
        [
            x[2] ** 2 - x[1] ** 2 - x[0] ** 2,
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 4.0,
        ]
    ),
    n=3,
    m=2,
    x_l=np.array([0.0, 0.0, 0.0]),
    x_u=np.array([INF, INF, 5.0]),
    g_l=np.array([0.0, 0.0]),
    g_u=np.array([INF, INF]),
    x0=np.array([0.0, 0.0, 3.0]),
)

_register(
    "hs035",
    f_star=1.0 / 9.0,
    x_star=[4.0 / 3.0, 7.0 / 9.0, 4.0 / 9.0],
    f=lambda x: (
        9.0
        - 8.0 * x[0]
        - 6.0 * x[1]
        - 4.0 * x[2]
        + 2.0 * x[0] ** 2
        + 2.0 * x[1] ** 2
        + x[2] ** 2
        + 2.0 * x[0] * x[1]
        + 2.0 * x[0] * x[2]
    ),
    g=lambda x: torch.stack([3.0 - x[0] - x[1] - 2.0 * x[2]]),  # linear
    n=3,
    m=1,
    num_linear=1,
    x_l=np.zeros(3),
    x_u=_bounds(3)[1],
    g_l=np.array([0.0]),
    g_u=np.array([INF]),
    x0=np.array([0.5, 0.5, 0.5]),
)

_register(
    "hs048",
    f_star=0.0,
    x_star=[1.0, 1.0, 1.0, 1.0, 1.0],
    f=lambda x: (x[0] - 1.0) ** 2 + (x[1] - x[2]) ** 2 + (x[3] - x[4]) ** 2,
    g=lambda x: torch.stack(
        [
            x[0] + x[1] + x[2] + x[3] + x[4] - 5.0,
            x[2] - 2.0 * (x[3] + x[4]) + 3.0,
        ]
    ),  # both linear
    n=5,
    m=2,
    num_linear=2,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.array([3.0, 5.0, -3.0, 2.0, -2.0]),
)


def _hs51_obj(x):
    return (
        (x[0] - x[1]) ** 2
        + (x[1] + x[2] - 2.0) ** 2
        + (x[3] - 1.0) ** 2
        + (x[4] - 1.0) ** 2
    )


_register(
    "hs051",
    f_star=0.0,
    x_star=[1.0, 1.0, 1.0, 1.0, 1.0],
    f=_hs51_obj,
    g=lambda x: torch.stack(
        [
            x[0] + 3.0 * x[1] - 4.0,
            x[2] + x[3] - 2.0 * x[4],
            x[1] - x[4],
        ]
    ),  # all linear
    n=5,
    m=3,
    num_linear=3,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([2.5, 0.5, 2.0, -1.0, 0.5]),
)

def _hs52_obj(x):
    return (
        (4.0 * x[0] - x[1]) ** 2
        + (x[1] + x[2] - 2.0) ** 2
        + (x[3] - 1.0) ** 2
        + (x[4] - 1.0) ** 2
    )


_register(
    "hs052",
    f_star=1859.0 / 349.0,
    f=_hs52_obj,
    g=lambda x: torch.stack(
        [
            x[0] + 3.0 * x[1],
            x[2] + x[3] - 2.0 * x[4],
            x[1] - x[4],
        ]
    ),
    n=5,
    m=3,
    num_linear=3,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([2.0, 2.0, 2.0, 2.0, 2.0]),
)

_register(
    "hs053",
    f_star=176.0 / 43.0,
    f=_hs51_obj,
    g=lambda x: torch.stack(
        [
            x[0] + 3.0 * x[1],
            x[2] + x[3] - 2.0 * x[4],
            x[1] - x[4],
        ]
    ),
    n=5,
    m=3,
    num_linear=3,
    x_l=np.full(5, -10.0),
    x_u=np.full(5, 10.0),
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([2.0, 2.0, 2.0, 2.0, 2.0]),
)

_register(
    "hs071",
    f_star=17.0140173,
    x_star=[1.0, 4.74299963, 3.82114998, 1.37940829],
    f=lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
    g=lambda x: torch.stack(
        [
            x[0] * x[1] * x[2] * x[3],
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2,
        ]
    ),
    n=4,
    m=2,
    x_l=np.ones(4),
    x_u=np.full(4, 5.0),
    g_l=np.array([25.0, 40.0]),
    g_u=np.array([INF, 40.0]),
    x0=np.array([1.0, 5.0, 5.0, 1.0]),
)

_register(
    "hs100",
    f_star=680.6300573,
    f=lambda x: (
        (x[0] - 10.0) ** 2
        + 5.0 * (x[1] - 12.0) ** 2
        + x[2] ** 4
        + 3.0 * (x[3] - 11.0) ** 2
        + 10.0 * x[4] ** 6
        + 7.0 * x[5] ** 2
        + x[6] ** 4
        - 4.0 * x[5] * x[6]
        - 10.0 * x[5]
        - 8.0 * x[6]
    ),
    g=lambda x: torch.stack(
        [
            127.0 - 2.0 * x[0] ** 2 - 3.0 * x[1] ** 4 - x[2] - 4.0 * x[3] ** 2 - 5.0 * x[4],
            282.0 - 7.0 * x[0] - 3.0 * x[1] - 10.0 * x[2] ** 2 - x[3] + x[4],
            196.0 - 23.0 * x[0] - x[1] ** 2 - 6.0 * x[5] ** 2 + 8.0 * x[6],
            -4.0 * x[0] ** 2
            - x[1] ** 2
            + 3.0 * x[0] * x[1]
            - 2.0 * x[2] ** 2
            - 5.0 * x[5]
            + 11.0 * x[6],
        ]
    ),
    n=7,
    m=4,
    x_l=_bounds(7)[0],
    x_u=_bounds(7)[1],
    g_l=np.zeros(4),
    g_u=np.full(4, INF),
    x0=np.array([1.0, 2.0, 0.0, 4.0, 0.0, 1.0, 1.0]),
)


# --- pathological cases (status-code coverage) -----------------------------


def infeasible_nlp() -> NLP:
    """x^2 <= -1: no feasible point -> Infeasible_Problem_Detected (status 2),
    exercising the FR failure path (sqp_trust_region.jl:152-159)."""
    return NLP(
        f=lambda x: x[0] ** 2,
        g=lambda x: torch.stack([x[0] ** 2]),
        n=1,
        m=1,
        x_l=np.array([-10.0]),
        x_u=np.array([10.0]),
        g_l=np.array([-INF]),
        g_u=np.array([-1.0]),
        x0=np.array([1.0]),
        name="infeasible",
    )


def unbounded_nlp() -> NLP:
    """min x, unconstrained -> Diverging_Iterates (status 4), exercising the
    unbounded heuristic (sqp_trust_region.jl:146-150)."""
    return NLP(
        f=lambda x: x[0],
        g=None,
        n=1,
        m=0,
        x_l=np.array([-INF]),
        x_u=np.array([INF]),
        g_l=np.zeros(0),
        g_u=np.zeros(0),
        x0=np.array([0.0]),
        name="unbounded",
    )


# --- additional battery problems ------------------------------------------

_register(
    "hs002",
    f_star=0.0504261879,
    f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
    g=None,
    n=2,
    m=0,
    x_l=np.array([-INF, 1.5]),
    x_u=np.array([INF, INF]),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.array([-2.0, 1.0]),
)

_register(
    "hs022",
    f_star=1.0,
    x_star=[1.0, 1.0],
    f=lambda x: (x[0] - 2.0) ** 2 + (x[1] - 1.0) ** 2,
    g=lambda x: torch.stack(
        [-x[0] - x[1] + 2.0, -(x[0] ** 2) + x[1]]
    ),  # linear first
    n=2,
    m=2,
    num_linear=1,
    x_l=_bounds(2)[0],
    x_u=_bounds(2)[1],
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.array([2.0, 2.0]),
)

_register(
    "hs023",
    f_star=2.0,
    x_star=[1.0, 1.0],
    f=lambda x: x[0] ** 2 + x[1] ** 2,
    g=lambda x: torch.stack(
        [
            x[0] + x[1] - 1.0,  # linear
            x[0] ** 2 + x[1] ** 2 - 1.0,
            9.0 * x[0] ** 2 + x[1] ** 2 - 9.0,
            x[0] ** 2 - x[1],
            x[1] ** 2 - x[0],
        ]
    ),
    n=2,
    m=5,
    num_linear=1,
    x_l=np.full(2, -50.0),
    x_u=np.full(2, 50.0),
    g_l=np.zeros(5),
    g_u=np.full(5, INF),
    x0=np.array([3.0, 1.0]),
)

_register(
    "hs030",
    f_star=1.0,
    x_star=[1.0, 0.0, 0.0],
    f=lambda x: x[0] ** 2 + x[1] ** 2 + x[2] ** 2,
    g=lambda x: torch.stack([x[0] ** 2 + x[1] ** 2 - 1.0]),
    n=3,
    m=1,
    x_l=np.array([1.0, -10.0, -10.0]),
    x_u=np.array([10.0, 10.0, 10.0]),
    g_l=np.array([0.0]),
    g_u=np.array([INF]),
    x0=np.array([1.0, 1.0, 1.0]),
)

_register(
    "hs043",  # Rosen-Suzuki
    f_star=-44.0,
    x_star=[0.0, 1.0, 2.0, -1.0],
    f=lambda x: (
        x[0] ** 2
        + x[1] ** 2
        + 2.0 * x[2] ** 2
        + x[3] ** 2
        - 5.0 * x[0]
        - 5.0 * x[1]
        - 21.0 * x[2]
        + 7.0 * x[3]
    ),
    g=lambda x: torch.stack(
        [
            8.0
            - x[0] ** 2
            - x[1] ** 2
            - x[2] ** 2
            - x[3] ** 2
            - x[0]
            + x[1]
            - x[2]
            + x[3],
            10.0
            - x[0] ** 2
            - 2.0 * x[1] ** 2
            - x[2] ** 2
            - 2.0 * x[3] ** 2
            + x[0]
            + x[3],
            5.0
            - 2.0 * x[0] ** 2
            - x[1] ** 2
            - x[2] ** 2
            - 2.0 * x[0]
            + x[1]
            + x[3],
        ]
    ),
    n=4,
    m=3,
    x_l=_bounds(4)[0],
    x_u=_bounds(4)[1],
    g_l=np.zeros(3),
    g_u=np.full(3, INF),
    x0=np.zeros(4),
)

_register(
    "hs065",
    f_star=0.9535288567,
    f=lambda x: (x[0] - x[1]) ** 2 + (x[0] + x[1] - 10.0) ** 2 / 9.0 + (x[2] - 5.0) ** 2,
    g=lambda x: torch.stack([48.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2]),
    n=3,
    m=1,
    x_l=np.array([-4.5, -4.5, -5.0]),
    x_u=np.array([4.5, 4.5, 5.0]),
    g_l=np.array([0.0]),
    g_u=np.array([INF]),
    x0=np.array([-5.0, 5.0, 0.0]),
)

_register(
    "hs076",
    f_star=-4.681818181,
    f=lambda x: (
        x[0] ** 2
        + 0.5 * x[1] ** 2
        + x[2] ** 2
        + 0.5 * x[3] ** 2
        - x[0] * x[2]
        + x[2] * x[3]
        - x[0]
        - 3.0 * x[1]
        + x[2]
        - x[3]
    ),
    g=lambda x: torch.stack(
        [
            5.0 - x[0] - 2.0 * x[1] - x[2] - x[3],
            4.0 - 3.0 * x[0] - x[1] - 2.0 * x[2] + x[3],
            x[1] + 4.0 * x[2] - 1.5,
        ]
    ),  # all linear
    n=4,
    m=3,
    num_linear=3,
    x_l=np.zeros(4),
    x_u=_bounds(4)[1],
    g_l=np.zeros(3),
    g_u=np.full(3, INF),
    x0=np.full(4, 0.5),
)


# --- round-2 battery extension (VERDICT r1 item 7: breadth >= 60) ----------
# Each problem restated from Hock & Schittkowski (1981) with the published
# f_star; includes degenerate/CQ-violating cases (hs013) and singular-Hessian
# cases (hs026/hs046/hs047).

_register(
    "hs013",  # constraint qualification fails at the solution
    f_star=1.0,
    x_star=[1.0, 0.0],
    f=lambda x: (x[0] - 2.0) ** 2 + x[1] ** 2,
    g=lambda x: torch.stack([(1.0 - x[0]) ** 3 - x[1]]),
    n=2,
    m=1,
    x_l=np.zeros(2),
    x_u=_bounds(2)[1],
    g_l=np.zeros(1),
    g_u=np.full(1, INF),
    x0=np.array([-2.0, -2.0]),
)

_register(
    "hs017",
    f_star=1.0,
    x_star=[0.0, 0.0],
    f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
    g=lambda x: torch.stack([x[1] ** 2 - x[0], x[0] ** 2 - x[1]]),
    n=2,
    m=2,
    x_l=np.array([-0.5, -INF]),
    x_u=np.array([0.5, 1.0]),
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.array([-2.0, 1.0]),
)

_register(
    "hs019",
    f_star=-6961.81388,
    f=lambda x: (x[0] - 10.0) ** 3 + (x[1] - 20.0) ** 3,
    g=lambda x: torch.stack(
        [
            (x[0] - 5.0) ** 2 + (x[1] - 5.0) ** 2 - 100.0,
            82.81 - (x[1] - 5.0) ** 2 - (x[0] - 6.0) ** 2,
        ]
    ),
    n=2,
    m=2,
    x_l=np.array([13.0, 0.0]),
    x_u=np.array([100.0, 100.0]),
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.array([20.1, 5.84]),
)

_register(
    "hs020",
    f_star=81.5 - 25.0 * np.sqrt(3.0),
    f=lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
    g=lambda x: torch.stack(
        [
            x[0] + x[1] ** 2,
            x[0] ** 2 + x[1],
            x[0] ** 2 + x[1] ** 2 - 1.0,
        ]
    ),
    n=2,
    m=3,
    x_l=np.array([-0.5, -INF]),
    x_u=np.array([0.5, INF]),
    g_l=np.zeros(3),
    g_u=np.full(3, INF),
    x0=np.array([-2.0, 1.0]),
)

_register(
    "hs024",
    f_star=-1.0,
    x_star=[3.0, np.sqrt(3.0)],
    f=lambda x: (
        ((x[0] - 3.0) ** 2 - 9.0) * x[1] ** 3 / (27.0 * math.sqrt(3.0))
    ),
    g=lambda x: torch.stack(
        [
            x[0] / math.sqrt(3.0) - x[1],
            x[0] + math.sqrt(3.0) * x[1],
            -x[0] - math.sqrt(3.0) * x[1] + 6.0,
        ]
    ),  # all linear
    n=2,
    m=3,
    num_linear=3,
    x_l=np.zeros(2),
    x_u=_bounds(2)[1],
    g_l=np.zeros(3),
    g_u=np.full(3, INF),
    x0=np.array([1.0, 0.5]),
)

_register(
    "hs026",  # singular Hessian at the solution
    f_star=0.0,
    f=lambda x: (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4,
    g=lambda x: torch.stack([(1.0 + x[1] ** 2) * x[0] + x[2] ** 4 - 3.0]),
    n=3,
    m=1,
    x_l=_bounds(3)[0],
    x_u=_bounds(3)[1],
    g_l=np.zeros(1),
    g_u=np.zeros(1),
    x0=np.array([-2.6, 2.0, 2.0]),
)

_register(
    "hs027",
    f_star=0.04,
    x_star=[-1.0, 1.0, 0.0],
    f=lambda x: 0.01 * (x[0] - 1.0) ** 2 + (x[1] - x[0] ** 2) ** 2,
    g=lambda x: torch.stack([x[0] + x[2] ** 2 + 1.0]),
    n=3,
    m=1,
    x_l=_bounds(3)[0],
    x_u=_bounds(3)[1],
    g_l=np.zeros(1),
    g_u=np.zeros(1),
    x0=np.array([2.0, 2.0, 2.0]),
)

_register(
    "hs029",
    f_star=-16.0 * np.sqrt(2.0),
    f=lambda x: -x[0] * x[1] * x[2],
    g=lambda x: torch.stack(
        [48.0 - x[0] ** 2 - 2.0 * x[1] ** 2 - 4.0 * x[2] ** 2]
    ),
    n=3,
    m=1,
    x_l=_bounds(3)[0],
    x_u=_bounds(3)[1],
    g_l=np.zeros(1),
    g_u=np.full(1, INF),
    x0=np.array([1.0, 1.0, 1.0]),
)

_register(
    "hs031",
    f_star=6.0,
    f=lambda x: 9.0 * x[0] ** 2 + x[1] ** 2 + 9.0 * x[2] ** 2,
    g=lambda x: torch.stack([x[0] * x[1] - 1.0]),
    n=3,
    m=1,
    x_l=np.array([-10.0, 1.0, -10.0]),
    x_u=np.array([10.0, 10.0, 1.0]),
    g_l=np.zeros(1),
    g_u=np.full(1, INF),
    x0=np.array([1.0, 1.0, 1.0]),
)

_register(
    "hs032",
    f_star=1.0,
    x_star=[0.0, 0.0, 1.0],
    f=lambda x: (x[0] + 3.0 * x[1] + x[2]) ** 2 + 4.0 * (x[0] - x[1]) ** 2,
    g=lambda x: torch.stack(
        [
            1.0 - x[0] - x[1] - x[2],  # linear eq
            6.0 * x[1] + 4.0 * x[2] - x[0] ** 3 - 3.0,
        ]
    ),
    n=3,
    m=2,
    num_linear=1,
    x_l=np.zeros(3),
    x_u=_bounds(3)[1],
    g_l=np.array([0.0, 0.0]),
    g_u=np.array([0.0, INF]),
    x0=np.array([0.1, 0.7, 0.2]),
)

_register(
    "hs034",
    f_star=-np.log(np.log(10.0)),
    f=lambda x: -x[0],
    g=lambda x: torch.stack([x[1] - torch.exp(x[0]), x[2] - torch.exp(x[1])]),
    n=3,
    m=2,
    x_l=np.zeros(3),
    x_u=np.array([100.0, 100.0, 10.0]),
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.array([0.0, 1.05, 2.9]),
)

_register(
    "hs036",
    f_star=-3300.0,
    x_star=[20.0, 11.0, 15.0],
    f=lambda x: -x[0] * x[1] * x[2],
    g=lambda x: torch.stack([72.0 - x[0] - 2.0 * x[1] - 2.0 * x[2]]),
    n=3,
    m=1,
    num_linear=1,
    x_l=np.zeros(3),
    x_u=np.array([20.0, 11.0, 42.0]),
    g_l=np.zeros(1),
    g_u=np.full(1, INF),
    x0=np.array([10.0, 10.0, 10.0]),
)

_register(
    "hs037",
    f_star=-3456.0,
    x_star=[24.0, 12.0, 12.0],
    f=lambda x: -x[0] * x[1] * x[2],
    g=lambda x: torch.stack(
        [
            72.0 - x[0] - 2.0 * x[1] - 2.0 * x[2],
            x[0] + 2.0 * x[1] + 2.0 * x[2],
        ]
    ),
    n=3,
    m=2,
    num_linear=2,
    x_l=np.zeros(3),
    x_u=np.full(3, 42.0),
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.array([10.0, 10.0, 10.0]),
)

_register(
    "hs038",  # Colville 4, bound-constrained
    f_star=0.0,
    x_star=[1.0, 1.0, 1.0, 1.0],
    f=lambda x: (
        100.0 * (x[1] - x[0] ** 2) ** 2
        + (1.0 - x[0]) ** 2
        + 90.0 * (x[3] - x[2] ** 2) ** 2
        + (1.0 - x[2]) ** 2
        + 10.1 * ((x[1] - 1.0) ** 2 + (x[3] - 1.0) ** 2)
        + 19.8 * (x[1] - 1.0) * (x[3] - 1.0)
    ),
    g=None,
    n=4,
    m=0,
    x_l=np.full(4, -10.0),
    x_u=np.full(4, 10.0),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.array([-3.0, -1.0, -3.0, -1.0]),
)

_register(
    "hs039",
    f_star=-1.0,
    x_star=[1.0, 1.0, 0.0, 0.0],
    f=lambda x: -x[0],
    g=lambda x: torch.stack(
        [
            x[1] - x[0] ** 3 - x[2] ** 2,
            x[0] ** 2 - x[1] - x[3] ** 2,
        ]
    ),
    n=4,
    m=2,
    x_l=_bounds(4)[0],
    x_u=_bounds(4)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.full(4, 2.0),
)

_register(
    "hs040",
    f_star=-0.25,
    f=lambda x: -x[0] * x[1] * x[2] * x[3],
    g=lambda x: torch.stack(
        [
            x[0] ** 3 + x[1] ** 2 - 1.0,
            x[0] ** 2 * x[3] - x[2],
            x[3] ** 2 - x[1],
        ]
    ),
    n=4,
    m=3,
    x_l=_bounds(4)[0],
    x_u=_bounds(4)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.full(4, 0.8),
)

_register(
    "hs041",
    f_star=52.0 / 27.0,
    x_star=[2.0 / 3.0, 1.0 / 3.0, 1.0 / 3.0, 2.0],
    f=lambda x: 2.0 - x[0] * x[1] * x[2],
    g=lambda x: torch.stack([x[0] + 2.0 * x[1] + 2.0 * x[2] - x[3]]),
    n=4,
    m=1,
    num_linear=1,
    x_l=np.zeros(4),
    x_u=np.array([1.0, 1.0, 1.0, 2.0]),
    g_l=np.zeros(1),
    g_u=np.zeros(1),
    x0=np.full(4, 2.0),
)

_register(
    "hs042",
    f_star=28.0 - 10.0 * np.sqrt(2.0),
    f=lambda x: (
        (x[0] - 1.0) ** 2
        + (x[1] - 2.0) ** 2
        + (x[2] - 3.0) ** 2
        + (x[3] - 4.0) ** 2
    ),
    g=lambda x: torch.stack(
        [x[0] - 2.0, x[2] ** 2 + x[3] ** 2 - 2.0]
    ),
    n=4,
    m=2,
    num_linear=1,
    x_l=_bounds(4)[0],
    x_u=_bounds(4)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.full(4, 1.0),
)

_register(
    "hs044",
    f_star=-15.0,
    x_star=[0.0, 3.0, 0.0, 4.0],
    f=lambda x: (
        x[0]
        - x[1]
        - x[2]
        - x[0] * x[2]
        + x[0] * x[3]
        + x[1] * x[2]
        - x[1] * x[3]
    ),
    g=lambda x: torch.stack(
        [
            8.0 - x[0] - 2.0 * x[1],
            12.0 - 4.0 * x[0] - x[1],
            12.0 - 3.0 * x[0] - 4.0 * x[1],
            8.0 - 2.0 * x[2] - x[3],
            8.0 - x[2] - 2.0 * x[3],
            5.0 - x[2] - x[3],
        ]
    ),  # all linear
    n=4,
    m=6,
    num_linear=6,
    x_l=np.zeros(4),
    x_u=_bounds(4)[1],
    g_l=np.zeros(6),
    g_u=np.full(6, INF),
    x0=np.zeros(4),
)

_register(
    "hs045",
    f_star=1.0,
    x_star=[1.0, 2.0, 3.0, 4.0, 5.0],
    f=lambda x: 2.0 - x[0] * x[1] * x[2] * x[3] * x[4] / 120.0,
    g=None,
    n=5,
    m=0,
    x_l=np.zeros(5),
    x_u=np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.full(5, 2.0),
)

_register(
    "hs046",  # singular Hessian at the solution
    f_star=0.0,
    f=lambda x: (
        (x[0] - x[1]) ** 2
        + (x[2] - 1.0) ** 2
        + (x[3] - 1.0) ** 4
        + (x[4] - 1.0) ** 6
    ),
    g=lambda x: torch.stack(
        [
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 1.0,
            x[1] + x[2] ** 4 * x[3] ** 2 - 2.0,
        ]
    ),
    n=5,
    m=2,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.array([np.sqrt(2.0) / 2.0, 1.75, 0.5, 2.0, 2.0]),
)

_register(
    "hs047",
    f_star=0.0,
    f=lambda x: (
        (x[0] - x[1]) ** 2
        + (x[1] - x[2]) ** 3
        + (x[2] - x[3]) ** 4
        + (x[3] - x[4]) ** 4
    ),
    g=lambda x: torch.stack(
        [
            x[0] + x[1] ** 2 + x[2] ** 3 - 3.0,
            x[1] - x[2] ** 2 + x[3] - 1.0,
            x[0] * x[4] - 1.0,
        ]
    ),
    n=5,
    m=3,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([2.0, np.sqrt(2.0), -1.0, 2.0 - np.sqrt(2.0), 0.5]),
)

_register(
    "hs049",
    f_star=0.0,
    f=lambda x: (
        (x[0] - x[1]) ** 2
        + (x[2] - 1.0) ** 2
        + (x[3] - 1.0) ** 4
        + (x[4] - 1.0) ** 6
    ),
    g=lambda x: torch.stack(
        [
            x[0] + x[1] + x[2] + 4.0 * x[3] - 7.0,
            x[2] + 5.0 * x[4] - 6.0,
        ]
    ),  # all linear
    n=5,
    m=2,
    num_linear=2,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.array([10.0, 7.0, 2.0, -3.0, 0.8]),
)

_register(
    "hs050",
    f_star=0.0,
    f=lambda x: (
        (x[0] - x[1]) ** 2
        + (x[1] - x[2]) ** 2
        + (x[2] - x[3]) ** 4
        + (x[3] - x[4]) ** 2
    ),
    g=lambda x: torch.stack(
        [
            x[0] + 2.0 * x[1] + 3.0 * x[2] - 6.0,
            x[1] + 2.0 * x[2] + 3.0 * x[3] - 6.0,
            x[2] + 2.0 * x[3] + 3.0 * x[4] - 6.0,
        ]
    ),  # all linear
    n=5,
    m=3,
    num_linear=3,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([35.0, -31.0, 11.0, 5.0, -5.0]),
)

_register(
    "hs055",
    f_star=19.0 / 3.0,
    f=lambda x: x[0] + 2.0 * x[1] + 4.0 * x[4] + torch.exp(x[0] * x[3]),
    g=lambda x: torch.stack(
        [
            x[0] + 2.0 * x[1] + 5.0 * x[4] - 6.0,
            x[0] + x[1] + x[2] - 3.0,
            x[3] + x[4] + x[5] - 2.0,
            x[0] + x[3] - 1.0,
            x[1] + x[4] - 2.0,
            x[2] + x[5] - 2.0,
        ]
    ),  # all linear (the exp term lives in the objective)
    n=6,
    m=6,
    num_linear=6,
    x_l=np.zeros(6),
    x_u=np.array([1.0, INF, INF, 1.0, INF, INF]),
    g_l=np.zeros(6),
    g_u=np.zeros(6),
    x0=np.array([1.0, 2.0, 0.0, 0.0, 0.0, 2.0]),
)

_register(
    "hs060",
    f_star=0.03256682,
    f=lambda x: (
        (x[0] - 1.0) ** 2 + (x[0] - x[1]) ** 2 + (x[1] - x[2]) ** 4
    ),
    g=lambda x: torch.stack(
        [
            x[0] * (1.0 + x[1] ** 2)
            + x[2] ** 4
            - 4.0
            - 3.0 * math.sqrt(2.0)
        ]
    ),
    n=3,
    m=1,
    x_l=np.full(3, -10.0),
    x_u=np.full(3, 10.0),
    g_l=np.zeros(1),
    g_u=np.zeros(1),
    x0=np.full(3, 2.0),
)

_register(
    "hs061",
    f_star=-143.6461422,
    f=lambda x: (
        4.0 * x[0] ** 2
        + 2.0 * x[1] ** 2
        + 2.0 * x[2] ** 2
        - 33.0 * x[0]
        + 16.0 * x[1]
        - 24.0 * x[2]
    ),
    g=lambda x: torch.stack(
        [
            3.0 * x[0] - 2.0 * x[1] ** 2 - 7.0,
            4.0 * x[0] - x[2] ** 2 - 11.0,
        ]
    ),
    n=3,
    m=2,
    x_l=_bounds(3)[0],
    x_u=_bounds(3)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.zeros(3),
)

_register(
    "hs063",
    f_star=961.7151721,
    f=lambda x: (
        1000.0
        - x[0] ** 2
        - 2.0 * x[1] ** 2
        - x[2] ** 2
        - x[0] * x[1]
        - x[0] * x[2]
    ),
    g=lambda x: torch.stack(
        [
            8.0 * x[0] + 14.0 * x[1] + 7.0 * x[2] - 56.0,  # linear
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 25.0,
        ]
    ),
    n=3,
    m=2,
    num_linear=1,
    x_l=np.zeros(3),
    x_u=_bounds(3)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.full(3, 2.0),
)

_register(
    "hs064",
    f_star=6299.842428,
    f=lambda x: (
        5.0 * x[0]
        + 50000.0 / x[0]
        + 20.0 * x[1]
        + 72000.0 / x[1]
        + 10.0 * x[2]
        + 144000.0 / x[2]
    ),
    g=lambda x: torch.stack(
        [1.0 - 4.0 / x[0] - 32.0 / x[1] - 120.0 / x[2]]
    ),
    n=3,
    m=1,
    x_l=np.full(3, 1.0e-5),
    x_u=_bounds(3)[1],
    g_l=np.zeros(1),
    g_u=np.full(1, INF),
    x0=np.full(3, 1.0),
)

_register(
    "hs066",
    f_star=0.5181632741,
    f=lambda x: 0.2 * x[2] - 0.8 * x[0],
    g=lambda x: torch.stack(
        [x[1] - torch.exp(x[0]), x[2] - torch.exp(x[1])]
    ),
    n=3,
    m=2,
    x_l=np.zeros(3),
    x_u=np.array([100.0, 100.0, 10.0]),
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.array([0.0, 1.05, 2.9]),
)

_register(
    "hs072",
    f_star=727.67937,
    f=lambda x: 1.0 + x[0] + x[1] + x[2] + x[3],
    g=lambda x: torch.stack(
        [
            0.0401
            - 4.0 / x[0]
            - 2.25 / x[1]
            - 1.0 / x[2]
            - 0.25 / x[3],
            0.010085
            - 0.16 / x[0]
            - 0.36 / x[1]
            - 0.64 / x[2]
            - 0.64 / x[3],
        ]
    ),
    n=4,
    m=2,
    x_l=np.full(4, 0.001),
    x_u=np.array([4.0e5, 3.0e5, 2.0e5, 1.0e5]),
    g_l=np.zeros(2),
    g_u=np.full(2, INF),
    x0=np.full(4, 1.0),
)

_register(
    "hs073",  # cattle feed
    f_star=29.894378,
    f=lambda x: (
        24.55 * x[0] + 26.75 * x[1] + 39.0 * x[2] + 40.50 * x[3]
    ),
    g=lambda x: torch.stack(
        [
            2.3 * x[0] + 5.6 * x[1] + 11.1 * x[2] + 1.3 * x[3] - 5.0,
            x[0] + x[1] + x[2] + x[3] - 1.0,
            12.0 * x[0]
            + 11.9 * x[1]
            + 41.8 * x[2]
            + 52.1 * x[3]
            - 21.0
            # +1e-12 guards the sqrt's derivative singularity at x = 0 (the
            # iterates can touch the x >= 0 boundary; a NaN Jacobian there
            # poisons the solve) — perturbs the optimum by ~1e-13
            - 1.645
            * torch.sqrt(
                0.28 * x[0] ** 2
                + 0.19 * x[1] ** 2
                + 20.5 * x[2] ** 2
                + 0.62 * x[3] ** 2
                + 1e-12
            ),
        ]
    ),  # linear ineq, linear eq... ordering: linear rows first
    n=4,
    m=3,
    num_linear=2,
    x_l=np.zeros(4),
    x_u=_bounds(4)[1],
    g_l=np.array([0.0, 0.0, 0.0]),
    g_u=np.array([INF, 0.0, INF]),
    x0=np.full(4, 1.0),
)

_register(
    "hs077",
    f_star=0.24150513,
    f=lambda x: (
        (x[0] - 1.0) ** 2
        + (x[0] - x[1]) ** 2
        + (x[2] - 1.0) ** 2
        + (x[3] - 1.0) ** 4
        + (x[4] - 1.0) ** 6
    ),
    g=lambda x: torch.stack(
        [
            x[0] ** 2 * x[3] + torch.sin(x[3] - x[4]) - 2.0 * math.sqrt(2.0),
            x[1] + x[2] ** 4 * x[3] ** 2 - 8.0 - math.sqrt(2.0),
        ]
    ),
    n=5,
    m=2,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(2),
    g_u=np.zeros(2),
    x0=np.full(5, 2.0),
)

_register(
    "hs078",
    f_star=-2.91970041,
    f=lambda x: x[0] * x[1] * x[2] * x[3] * x[4],
    g=lambda x: torch.stack(
        [
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ]
    ),
    n=5,
    m=3,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([-2.0, 1.5, 2.0, -1.0, -1.0]),
)

_register(
    "hs079",
    f_star=0.0787768209,
    f=lambda x: (
        (x[0] - 1.0) ** 2
        + (x[0] - x[1]) ** 2
        + (x[1] - x[2]) ** 2
        + (x[2] - x[3]) ** 4
        + (x[3] - x[4]) ** 4
    ),
    g=lambda x: torch.stack(
        [
            x[0] + x[1] ** 2 + x[2] ** 3 - 2.0 - 3.0 * math.sqrt(2.0),
            x[1] - x[2] ** 2 + x[3] + 2.0 - 2.0 * math.sqrt(2.0),
            x[0] * x[4] - 2.0,
        ]
    ),
    n=5,
    m=3,
    x_l=_bounds(5)[0],
    x_u=_bounds(5)[1],
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.full(5, 2.0),
)

_register(
    "hs080",
    f_star=0.0539498478,
    f=lambda x: torch.exp(x[0] * x[1] * x[2] * x[3] * x[4]),
    g=lambda x: torch.stack(
        [
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ]
    ),
    n=5,
    m=3,
    x_l=np.array([-2.3, -2.3, -3.2, -3.2, -3.2]),
    x_u=np.array([2.3, 2.3, 3.2, 3.2, 3.2]),
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([-2.0, 2.0, 2.0, -1.0, -1.0]),
)

_register(
    "hs081",
    f_star=0.0539498478,
    f=lambda x: (
        torch.exp(x[0] * x[1] * x[2] * x[3] * x[4])
        - 0.5 * (x[0] ** 3 + x[1] ** 3 + 1.0) ** 2
    ),
    g=lambda x: torch.stack(
        [
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 + x[4] ** 2 - 10.0,
            x[1] * x[2] - 5.0 * x[3] * x[4],
            x[0] ** 3 + x[1] ** 3 + 1.0,
        ]
    ),
    n=5,
    m=3,
    x_l=np.array([-2.3, -2.3, -3.2, -3.2, -3.2]),
    x_u=np.array([2.3, 2.3, 3.2, 3.2, 3.2]),
    g_l=np.zeros(3),
    g_u=np.zeros(3),
    x0=np.array([-2.0, 2.0, 2.0, -1.0, -1.0]),
)

_HS083_A = [
    85.334407, 0.0056858, 0.0006262, 0.0022053,
    80.51249, 0.0071317, 0.0029955, 0.0021813,
    9.300961, 0.0047026, 0.0012547, 0.0019085,
]

_register(
    "hs083",  # Himmelblau's process-design problem
    f_star=-30665.53867,
    f=lambda x: (
        5.3578547 * x[2] ** 2
        + 0.8356891 * x[0] * x[4]
        + 37.293239 * x[0]
        - 40792.141
    ),
    g=lambda x: torch.stack(
        [
            _HS083_A[0]
            + _HS083_A[1] * x[1] * x[4]
            + _HS083_A[2] * x[0] * x[3]
            - _HS083_A[3] * x[2] * x[4],
            _HS083_A[4]
            + _HS083_A[5] * x[1] * x[4]
            + _HS083_A[6] * x[0] * x[1]
            + _HS083_A[7] * x[2] ** 2,
            _HS083_A[8]
            + _HS083_A[9] * x[2] * x[4]
            + _HS083_A[10] * x[0] * x[2]
            + _HS083_A[11] * x[2] * x[3],
        ]
    ),
    n=5,
    m=3,
    x_l=np.array([78.0, 33.0, 27.0, 27.0, 27.0]),
    x_u=np.array([102.0, 45.0, 45.0, 45.0, 45.0]),
    g_l=np.array([0.0, 90.0, 20.0]),
    g_u=np.array([92.0, 110.0, 25.0]),
    x0=np.array([78.0, 33.0, 27.0, 27.0, 27.0]),
)

_register(
    "hs106",  # heat-exchanger design
    f_star=7049.330923,
    f=lambda x: x[0] + x[1] + x[2],
    g=lambda x: torch.stack(
        [
            1.0 - 0.0025 * (x[3] + x[5]),  # linear
            1.0 - 0.0025 * (x[4] + x[6] - x[3]),  # linear
            1.0 - 0.01 * (x[7] - x[4]),  # linear
            x[0] * x[5] - 833.33252 * x[3] - 100.0 * x[0] + 83333.333,
            x[1] * x[6] - 1250.0 * x[4] - x[1] * x[3] + 1250.0 * x[3],
            x[2] * x[7] - 1250000.0 - x[2] * x[4] + 2500.0 * x[4],
        ]
    ),
    n=8,
    m=6,
    num_linear=3,
    x_l=np.array([100.0, 1000.0, 1000.0, 10.0, 10.0, 10.0, 10.0, 10.0]),
    x_u=np.array(
        [10000.0, 10000.0, 10000.0, 1000.0, 1000.0, 1000.0, 1000.0, 1000.0]
    ),
    g_l=np.zeros(6),
    g_u=np.full(6, INF),
    x0=np.array([5000.0, 5000.0, 5000.0, 200.0, 350.0, 150.0, 225.0, 425.0]),
)

_register(
    "hs110",  # bound-constrained, n = 10
    f_star=-45.77846971,
    f=lambda x: (
        torch.sum(torch.log(x - 2.0) ** 2 + torch.log(10.0 - x) ** 2)
        - torch.prod(x) ** 0.2
    ),
    g=None,
    n=10,
    m=0,
    x_l=np.full(10, 2.001),
    x_u=np.full(10, 9.999),
    g_l=np.zeros(0),
    g_u=np.zeros(0),
    x0=np.full(10, 9.0),
)

_register(
    "hs113",  # Wong nr. 2
    f_star=24.30620907,
    f=lambda x: (
        x[0] ** 2
        + x[1] ** 2
        + x[0] * x[1]
        - 14.0 * x[0]
        - 16.0 * x[1]
        + (x[2] - 10.0) ** 2
        + 4.0 * (x[3] - 5.0) ** 2
        + (x[4] - 3.0) ** 2
        + 2.0 * (x[5] - 1.0) ** 2
        + 5.0 * x[6] ** 2
        + 7.0 * (x[7] - 11.0) ** 2
        + 2.0 * (x[8] - 10.0) ** 2
        + (x[9] - 7.0) ** 2
        + 45.0
    ),
    g=lambda x: torch.stack(
        [
            105.0 - 4.0 * x[0] - 5.0 * x[1] + 3.0 * x[6] - 9.0 * x[7],
            -10.0 * x[0] + 8.0 * x[1] + 17.0 * x[6] - 2.0 * x[7],
            8.0 * x[0] - 2.0 * x[1] - 5.0 * x[8] + 2.0 * x[9] + 12.0,
            -3.0 * (x[0] - 2.0) ** 2
            - 4.0 * (x[1] - 3.0) ** 2
            - 2.0 * x[2] ** 2
            + 7.0 * x[3]
            + 120.0,
            -5.0 * x[0] ** 2
            - 8.0 * x[1]
            - (x[2] - 6.0) ** 2
            + 2.0 * x[3]
            + 40.0,
            -(x[0] ** 2)
            - 2.0 * (x[1] - 2.0) ** 2
            + 2.0 * x[0] * x[1]
            - 14.0 * x[4]
            + 6.0 * x[5],
            -0.5 * (x[0] - 8.0) ** 2
            - 2.0 * (x[1] - 4.0) ** 2
            - 3.0 * x[4] ** 2
            + x[5]
            + 30.0,
            3.0 * x[0]
            - 6.0 * x[1]
            - 12.0 * (x[8] - 8.0) ** 2
            + 7.0 * x[9],
        ]
    ),
    n=10,
    m=8,
    num_linear=3,
    x_l=_bounds(10)[0],
    x_u=_bounds(10)[1],
    g_l=np.zeros(8),
    g_u=np.full(8, INF),
    x0=np.array([2.0, 3.0, 5.0, 5.0, 1.0, 2.0, 7.0, 3.0, 6.0, 10.0]),
)

_register(
    "hs118",  # QP with banded linear constraints, n = 15
    f_star=664.8204500,
    f=lambda x: torch.sum(
        2.3 * x[0::3]
        + 0.0001 * x[0::3] ** 2
        + 1.7 * x[1::3]
        + 0.0001 * x[1::3] ** 2
        + 2.2 * x[2::3]
        + 0.00015 * x[2::3] ** 2
    ),
    g=lambda x: torch.cat(
        [
            x[3::3] - x[0:-3:3] + 7.0,  # 0 <= . <= 13
            x[4::3] - x[1:-3:3] + 7.0,  # 0 <= . <= 14
            x[5::3] - x[2:-3:3] + 7.0,  # 0 <= . <= 13
            torch.stack(
                [
                    x[0] + x[1] + x[2] - 60.0,
                    x[3] + x[4] + x[5] - 50.0,
                    x[6] + x[7] + x[8] - 70.0,
                    x[9] + x[10] + x[11] - 85.0,
                    x[12] + x[13] + x[14] - 100.0,
                ]
            ),
        ]
    ),  # all linear
    n=15,
    m=17,
    num_linear=17,
    x_l=np.array(
        [8.0, 43.0, 3.0] + [0.0, 0.0, 0.0] * 4
    ),
    x_u=np.array(
        [21.0, 57.0, 16.0] + [90.0, 120.0, 60.0] * 4
    ),
    g_l=np.array([0.0] * 12 + [0.0] * 5),
    g_u=np.array([13.0] * 4 + [14.0] * 4 + [13.0] * 4 + [INF] * 5),
    x0=np.array(
        [20.0, 55.0, 15.0, 20.0, 60.0, 20.0, 20.0, 60.0, 20.0, 20.0,
         60.0, 20.0, 20.0, 60.0, 20.0]
    ),
)
