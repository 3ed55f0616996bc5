"""Cross-scenario coupled (two-stage stochastic) NLPs (torch port of the JAX
package's ``models/stochastic.py``).

:func:`couple_scenarios` lifts a theta-parameterized base :class:`NLP` into
ONE NLP over the stacked variable vector::

    z = [ s (shared) | y_0 | y_1 | ... | y_{K-1} ]      (ns + K*nl variables)

with objective ``sum_k w_k f(x_k, theta_k)`` and the K scenario constraint
blocks stacked (all linear rows first, the canonical ordering of
``nlp.py``).  Scenario k sees ``x_k``: the shared ``s`` and its own locals
``y_k`` in the base problem's variable order.  The scenarios are evaluated
by ``torch.func.vmap``.

The coupled problem is bordered-block-diagonal: the scenario locals are the
interiors and the shared first-stage variables the separator.  With
``Parameters(kkt_structured=True)`` its KKT systems factor as batched dense
Cholesky blocks plus one dense separator Schur complement
(:mod:`sqpsolver_tpu_torch.ops.kkt_bbd`), never forming the dense
``(ns + K*nl)^2`` matrix.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ..nlp import NLP
from ..structure import NLPStructure, detect_structure


def _leading_dim(thetas: dict) -> int:
    if not thetas:
        raise ValueError("thetas has no entries")
    sizes = {int(np.asarray(v).shape[0]) for v in thetas.values()}
    if len(sizes) != 1:
        raise ValueError("all theta entries need the same leading dim K")
    return sizes.pop()


def couple_scenarios(
    nlp: NLP,
    thetas: dict,
    shared_mask,
    weights=None,
    name: str | None = None,
) -> NLP:
    """Couple K scenarios of ``nlp`` through shared first-stage variables.

    * ``nlp`` -- theta-parameterized base problem (``nlp.theta`` set).
    * ``thetas`` -- scenario parameters, a dict of arrays stacked on a
      leading axis of size K (e.g. ``acopf.load_scenarios``).  They become
      the coupled problem's ``theta``.
    * ``shared_mask (n,) bool`` -- True for variables shared across
      scenarios, False for per-scenario locals.
    * ``weights (K,)`` -- objective weights (default uniform ``1/K``, the
      expected cost over equiprobable scenarios).

    Returns an :class:`NLP` with ``n = ns + K*nl`` variables, ``m = K *
    nlp.m`` rows (all scenarios' linear rows first) and a block structure
    whose interiors are the per-scenario locals and whose separator is the
    shared block, ready for ``kkt_structured=True``.
    """
    if nlp.theta is None:
        raise ValueError(
            "couple_scenarios needs a theta-parameterized base NLP (nlp.theta set)"
        )
    shared_mask = np.asarray(shared_mask, bool)
    if shared_mask.shape != (nlp.n,):
        raise ValueError(f"shared_mask must have shape ({nlp.n},)")
    K = _leading_dim(thetas)
    sh_idx = np.nonzero(shared_mask)[0]
    loc_idx = np.nonzero(~shared_mask)[0]
    ns, nl = len(sh_idx), len(loc_idx)
    if ns == 0:
        raise ValueError(
            "no shared variables: solve the scenarios as an ordinary batch "
            "(parallel.batch) instead"
        )
    n_base, m_base, ml = nlp.n, nlp.m, nlp.num_linear
    mnl = m_base - ml
    n_new = ns + K * nl
    m_new = K * m_base
    if weights is None:
        w_np = np.full((K,), 1.0 / K)
    else:
        w_np = np.asarray(weights, np.float64)
        if w_np.shape != (K,):
            raise ValueError(f"weights must have shape ({K},)")
    # position of each base variable in a scenario's [s (ns) | y_k (nl)]
    pick = np.empty(n_base, dtype=np.int64)
    pick[sh_idx] = np.arange(ns)
    pick[loc_idx] = ns + np.arange(nl)
    consts = {}

    def const(z):
        """The gather index and the weights on ``z``'s device and dtype."""
        key = (z.device, z.dtype)
        if key not in consts:
            consts[key] = (
                torch.as_tensor(pick, device=z.device),
                torch.as_tensor(w_np, dtype=z.dtype, device=z.device),
            )
        return consts[key]

    def scenario_points(z):
        """(K, n_base): every scenario's full variable vector, a gather."""
        s = z[:ns]
        Y = z[ns:].reshape(K, nl)
        return torch.cat([s.expand(K, ns), Y], dim=1)[:, const(z)[0]]

    def f_new(z, TH):
        fvals = vmap(nlp.f)(scenario_points(z), TH)
        return const(z)[1] @ fvals

    def g_new(z, TH):
        G = vmap(nlp.g)(scenario_points(z), TH)  # (K, m_base)
        # canonical ordering: every scenario's linear rows first
        return torch.cat([G[:, :ml].reshape(-1), G[:, ml:].reshape(-1)])

    def stack_vars(a):
        a = np.broadcast_to(np.asarray(a, np.float64), (n_base,))
        return np.concatenate([a[sh_idx], np.tile(a[loc_idx], K)])

    def stack_rows(a):
        a = np.broadcast_to(np.asarray(a, np.float64), (m_base,))
        return np.concatenate([np.tile(a[:ml], K), np.tile(a[ml:], K)])

    # ---- block structure: scenario locals = interiors, shared = separator --
    base_struct = nlp.structure or detect_structure(nlp)
    loc_slot = np.full(n_base, -1, np.int64)
    loc_slot[loc_idx] = np.arange(nl)
    sh_slot = np.full(n_base, -1, np.int64)
    sh_slot[sh_idx] = np.arange(ns)

    def map_col(c, k):
        c = int(c)
        return sh_slot[c] if shared_mask[c] else ns + k * nl + loc_slot[c]

    row_cols = [None] * m_new
    for k in range(K):
        for i in range(m_base):
            cols = np.asarray([map_col(c, k) for c in base_struct.row_cols[i]], np.int64)
            new_row = k * ml + i if i < ml else K * ml + k * mnl + (i - ml)
            row_cols[new_row] = np.sort(cols)
    obj_pairs = []
    for k in range(K):
        for a, b in np.asarray(base_struct.obj_pairs).reshape(-1, 2):
            obj_pairs.append((map_col(a, k), map_col(b, k)))
    structure = NLPStructure(
        row_cols=tuple(row_cols),
        obj_pairs=np.asarray(obj_pairs, np.int64).reshape(-1, 2),
    )

    return NLP(
        f=f_new,
        g=g_new if m_new > 0 else None,
        n=n_new,
        m=m_new,
        x_l=stack_vars(nlp.x_l),
        x_u=stack_vars(nlp.x_u),
        g_l=stack_rows(nlp.g_l),
        g_u=stack_rows(nlp.g_u),
        x0=stack_vars(nlp.x0),
        num_linear=K * ml,
        maximize=nlp.maximize,
        name=name or f"{nlp.name}_coupled{K}",
        theta={k: np.asarray(v) for k, v in thetas.items()},
        structure=structure,
    )


def pg_shared_mask(case, nlp: NLP) -> np.ndarray:
    """Shared-variable mask for stochastic ACOPF with here-and-now active
    dispatch: generator ``pg`` is set before the scenario realizes (the
    two-stage OPF first stage); voltages and reactive power adjust per
    scenario.  Matches the [va, vm, pg, qg] layout of ``acopf_polar``.

    Generators at the reference (slack) bus stay per-scenario: with every
    ``pg`` fixed before the load realizes, the active balance could close
    only through losses, and a few-percent load spread makes the problem
    infeasible; the slack generator is the recourse."""
    nb, ng = case.nb, case.ng
    mask = np.zeros(nlp.n, bool)
    mask[2 * nb : 2 * nb + ng] = True
    slack_gens = 2 * nb + np.nonzero(np.asarray(case.gen_bus) == case.ref_bus)[0]
    mask[slack_gens] = False
    return mask
