"""Problem specification and AD derivative bundle (PyTorch port of the JAX
package's ``nlp.py``).

The user supplies *pure functions* ``f(x)`` and ``g(x)`` of ONE instance
(``x`` of shape ``(n,)``, optional scenario parameters ``theta``) written in
torch ops; every derivative comes from ``torch.func`` and is batched over a
leading instance axis with ``torch.func.vmap`` over ``(x, lambda, theta)``:

* ``obj_grad``  -> ``(f (B,), grad f (B, n))``  via ``grad_and_value``;
* ``cons_jac``  -> ``J (B, m, n)``               via ``jacfwd``;
* ``lag_hess``  -> ``H (B, n, n)``               via ``hessian`` of
  ``f + lambda @ g`` (objective factor sigma = 1).

Semantics kept from the JAX package: linear rows first (only
``num_linear`` matters algorithmically), max->min through an objective
scale of -1, equality rows as ``g_L == g_U``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad_and_value, hessian, jacfwd, vmap


@dataclasses.dataclass(frozen=True)
class NLP:
    """A continuous nonlinear program

        min  f(x)   s.t.  g_L <= g(x) <= g_U,   x_L <= x <= x_U.

    ``f`` and ``g`` take one ``(n,)`` tensor (and ``theta`` when the NLP has
    scenario parameters) and must be traceable by ``torch.func``; ``g``
    returns an ``(m,)`` tensor with the ``num_linear`` linear rows first.
    Bounds and ``x0`` are numpy arrays; :meth:`data` turns them into tensors
    on a given device and dtype.
    """

    f: Callable
    g: Optional[Callable]  # None <=> unconstrained (m == 0)
    n: int
    m: int
    x_l: np.ndarray
    x_u: np.ndarray
    g_l: np.ndarray
    g_u: np.ndarray
    x0: np.ndarray
    num_linear: int = 0
    maximize: bool = False
    name: str = "nlp"
    #: example scenario-parameter dict (numpy arrays); when set, ``f`` and
    #: ``g`` take it as a second argument, one instance's slice per lane
    theta: Optional[dict] = None
    #: optional static sparsity pattern (``structure.NLPStructure``) that
    #: enables the block-structured (BBD) KKT path, ``kkt_structured=True``;
    #: None = dense path only
    structure: Optional[object] = None

    def __post_init__(self):
        if self.n == 0:
            raise ValueError("NLP with zero variables is invalid")
        if self.m == 0 and self.g is not None:
            raise ValueError("m == 0 requires g=None")
        if self.m > 0 and self.g is None:
            raise ValueError("m > 0 requires a constraint function g")
        if not (0 <= self.num_linear <= self.m):
            raise ValueError("num_linear must be in [0, m]")

    # ------------------------------------------------- one instance -------
    def obj(self, x: torch.Tensor, theta=None) -> torch.Tensor:
        """Objective of one instance in internal (minimization) convention."""
        fx = self.f(x) if self.theta is None else self.f(x, theta)
        return -fx if self.maximize else fx

    def cons(self, x: torch.Tensor, theta=None) -> torch.Tensor:
        """Constraint values g(x) of one instance; shape (m,)."""
        if self.g is None:
            return x.new_zeros((0,))
        return self.g(x) if self.theta is None else self.g(x, theta)

    # ------------------------------------------------- batched AD ---------
    def _theta_dim(self, theta):
        return 0 if (self.theta is not None and theta is not None) else None

    def obj_grad(self, x: torch.Tensor, theta=None):
        """Batched ``(f (B,), grad f (B, n))``."""
        gv = grad_and_value(self.obj)
        df, f = vmap(gv, in_dims=(0, self._theta_dim(theta)))(x, theta)
        return f, df

    def obj_cons(self, x: torch.Tensor, theta=None):
        """Batched ``(f (B,), g (B, m))`` at trial points."""
        f = vmap(self.obj, in_dims=(0, self._theta_dim(theta)))(x, theta)
        if self.g is None:
            return f, x.new_zeros((x.shape[0], 0))
        g = vmap(self.cons, in_dims=(0, self._theta_dim(theta)))(x, theta)
        return f, g

    def cons_jac(self, x: torch.Tensor, theta=None) -> torch.Tensor:
        """Batched dense constraint Jacobian ``(B, m, n)`` (forward mode)."""
        if self.g is None:
            return x.new_zeros((x.shape[0], 0, self.n))
        return vmap(jacfwd(self.cons), in_dims=(0, self._theta_dim(theta)))(
            x, theta
        )

    def lag_hess(self, x: torch.Tensor, lam: torch.Tensor, theta=None):
        """Batched dense Lagrangian Hessian ``hess(f + lam @ g)``, (B, n, n)."""

        def lagrangian(z, lm, th):
            val = self.obj(z, th)
            if self.g is not None:
                val = val + torch.dot(lm, self.cons(z, th))
            return val

        return vmap(hessian(lagrangian), in_dims=(0, 0, self._theta_dim(theta)))(
            x, lam, theta
        )

    # ------------------------------------------------------ data ----------
    def data(self, dtype=torch.float64, device=None, theta=None) -> "NLPData":
        """The numeric problem data of one instance as tensors on ``device``
        (``None``: the CUDA card, see :func:`resolve_device`)."""
        device = resolve_device(device)

        def conv(a, size):
            arr = np.broadcast_to(np.asarray(a, dtype=np.float64), (size,))
            return torch.tensor(arr, dtype=dtype, device=device)

        if theta is None:
            theta = self.theta
        if theta is not None:
            theta = {
                k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in theta.items()
            }
        return NLPData(
            x_l=conv(self.x_l, self.n),
            x_u=conv(self.x_u, self.n),
            g_l=conv(self.g_l, self.m),
            g_u=conv(self.g_u, self.m),
            x0=conv(self.x0, self.n),
            theta=theta,
        )


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on.  ``None`` means the
    CUDA card; without one this raises rather than carry on on the CPU, which
    a caller asks for with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and none was named: this package runs "
            'on the GPU by default; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


@dataclasses.dataclass
class NLPData:
    """Numeric problem data: bounds, start point, scenario parameters and an
    optional constraint-multiplier warm start ``lam0``.  The solver takes it
    with a leading batch axis on every tensor (see ``parallel.batch``)."""

    x_l: torch.Tensor
    x_u: torch.Tensor
    g_l: torch.Tensor
    g_u: torch.Tensor
    x0: torch.Tensor
    theta: Optional[dict] = None
    lam0: Optional[torch.Tensor] = None


def initial_point(data: NLPData) -> torch.Tensor:
    """Initial iterate: the user start clamped to the variable bounds."""
    return torch.clamp(data.x0, min=data.x_l, max=data.x_u)


def build_nlp(
    f: Callable,
    x0,
    *,
    x_l=None,
    x_u=None,
    eq: Optional[Callable] = None,
    ineq: Optional[Callable] = None,
    ineq_l=None,
    ineq_u=None,
    linear: Optional[Callable] = None,
    linear_l=None,
    linear_u=None,
    maximize: bool = False,
    name: str = "nlp",
) -> NLP:
    """Assemble an :class:`NLP` from separate constraint groups: ``linear``
    rows first (``linear_l <= linear(x) <= linear_u``), then nonlinear
    equalities ``eq(x) == 0``, then ``ineq_l <= ineq(x) <= ineq_u``
    (defaults ``-inf`` / ``0``)."""
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.shape[0]
    inf = np.inf
    probe = torch.as_tensor(x0)
    sizes = {}
    for key, fn in (("linear", linear), ("eq", eq), ("ineq", ineq)):
        sizes[key] = 0 if fn is None else int(torch.atleast_1d(fn(probe)).shape[0])
    m_lin, m_eq, m_in = sizes["linear"], sizes["eq"], sizes["ineq"]
    m = m_lin + m_eq + m_in

    def full_g(x):
        parts = [
            torch.atleast_1d(fn(x)) for fn in (linear, eq, ineq) if fn is not None
        ]
        return torch.cat(parts)

    def bound(val, default, size):
        if val is None:
            val = default
        return np.broadcast_to(np.asarray(val, dtype=np.float64), (size,))

    g_l = np.concatenate(
        [bound(linear_l, -inf, m_lin), np.zeros(m_eq), bound(ineq_l, -inf, m_in)]
    )
    g_u = np.concatenate(
        [bound(linear_u, +inf, m_lin), np.zeros(m_eq), bound(ineq_u, 0.0, m_in)]
    )
    return NLP(
        f=f,
        g=full_g if m > 0 else None,
        n=n,
        m=m,
        x_l=bound(x_l, -inf, n),
        x_u=bound(x_u, +inf, n),
        g_l=g_l,
        g_u=g_u,
        x0=x0,
        num_linear=m_lin,
        maximize=maximize,
        name=name,
    )
