"""AC Optimal Power Flow in polar form (ACP) as a torch NLP.

Port of the JAX package's ``models/acopf.py`` ``acopf_polar`` with its
analytic sparsity (``acopf_polar_structure``, for the block-structured KKT
path) and ``load_scenarios``: minimize polynomial generation cost subject to the
reference-bus angle, bus power balance and branch thermal limits.  Loads
(pd, qd) enter through the NLP ``theta`` dict, so one solver runs a batch of
load scenarios.

The JAX ``.at[idx].add`` scatters (branch flows and generation summed into
their buses) become products with constant 0/1 incidence matrices:
``torch.func`` traces them, and they sum in a fixed order.  ``index_add`` on
a CUDA device sums with atomics in whatever order the threads arrive, which
made two runs of one solve differ in the last bit of a bus balance and, many
float32-factorized interior-point trips later, in their trip counts and
sometimes in where a lane stopped.  The network constants are built once per
(device, dtype) the first time an evaluation meets them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLP
from .power import PowerCase

INF = np.inf


def acopf_polar(case: PowerCase, scenario_batchable: bool = True) -> NLP:
    """Polar (ACP) formulation.

    Variables  x = [va (nb), vm (nb), pg (ng), qg (ng)].
    Rows (linear first): ref-bus angle; P balance (nb); Q balance (nb);
    from/to thermal limits (2*nl).
    """
    if case.n_pwl_gen or case.ndc:
        raise NotImplementedError(
            "acopf_polar in the torch port covers polynomial costs without "
            "dclines; PWL costs and HVDC lines wait for the other models "
            "(ROADMAP, later-PR list item 8)"
        )
    nb, ng, nl = case.nb, case.ng, case.nl
    adm = np.stack(case.admittances())  # (8, nl): gff bff gft bft gtf btf gtt btt
    base = float(case.baseMVA)
    has_rate = np.isfinite(case.br_rate) & (case.br_rate > 0)
    rate2 = np.where(has_rate, case.br_rate**2, 1.0e4)
    consts = {}

    def incidence(idx, width):
        """(nb, width) 0/1 matrix that sums entries ``j`` into bus ``idx[j]``."""
        inc = np.zeros((nb, width))
        inc[np.asarray(idx), np.arange(width)] = 1.0
        return inc

    def const(ref: torch.Tensor) -> dict:
        key = (ref.device, ref.dtype)
        if key not in consts:
            fl = dict(dtype=ref.dtype, device=ref.device)
            ix = dict(dtype=torch.long, device=ref.device)
            consts[key] = dict(
                adm=torch.as_tensor(adm, **fl),
                f_idx=torch.as_tensor(case.br_f, **ix),
                t_idx=torch.as_tensor(case.br_t, **ix),
                into_gen_bus=torch.as_tensor(incidence(case.gen_bus, ng), **fl),
                into_f=torch.as_tensor(incidence(case.br_f, nl), **fl),
                into_t=torch.as_tensor(incidence(case.br_t, nl), **fl),
                gs=torch.as_tensor(case.bus_gs, **fl),
                bs=torch.as_tensor(case.bus_bs, **fl),
                pd=torch.as_tensor(case.bus_pd, **fl),
                qd=torch.as_tensor(case.bus_qd, **fl),
                c2=torch.as_tensor(case.cost_c2, **fl),
                c1=torch.as_tensor(case.cost_c1, **fl),
                c0=torch.as_tensor(case.cost_c0, **fl),
            )
        return consts[key]

    def split(x):
        return x[:nb], x[nb : 2 * nb], x[2 * nb : 2 * nb + ng], x[2 * nb + ng :]

    def flows(va, vm, k):
        Gff, Bff, Gft, Bft, Gtf, Btf, Gtt, Btt = k["adm"]
        vf, vt = vm[k["f_idx"]], vm[k["t_idx"]]
        d = va[k["f_idx"]] - va[k["t_idx"]]
        A = vf * vt * torch.cos(d)
        B = vf * vt * torch.sin(d)
        vf2 = vf * vf
        vt2 = vt * vt
        p_f = Gff * vf2 + Gft * A + Bft * B
        q_f = -Bff * vf2 - Bft * A + Gft * B
        p_t = Gtt * vt2 + Gtf * A - Btf * B
        q_t = -Btt * vt2 - Btf * A - Gtf * B
        return p_f, q_f, p_t, q_t

    def f(x, theta=None):
        k = const(x)
        pg = split(x)[2]
        mw = pg * base
        return torch.sum(k["c2"] * mw * mw + k["c1"] * mw + k["c0"])

    def g(x, theta=None):
        k = const(x)
        va, vm, pg, qg = split(x)
        pd = theta["pd"] if theta is not None else k["pd"]
        qd = theta["qd"] if theta is not None else k["qd"]
        p_f, q_f, p_t, q_t = flows(va, vm, k)
        vm2 = vm * vm
        p_inj = (
            k["into_gen_bus"] @ pg
            - pd
            - k["gs"] * vm2
            - k["into_f"] @ p_f
            - k["into_t"] @ p_t
        )
        q_inj = (
            k["into_gen_bus"] @ qg
            - qd
            + k["bs"] * vm2
            - k["into_f"] @ q_f
            - k["into_t"] @ q_t
        )
        s_from = p_f * p_f + q_f * q_f
        s_to = p_t * p_t + q_t * q_t
        ref = x[case.ref_bus : case.ref_bus + 1]
        return torch.cat([ref, p_inj, q_inj, s_from, s_to])

    n = 2 * nb + 2 * ng
    m = 1 + 2 * nb + 2 * nl
    g_l = np.concatenate([np.zeros(1), np.zeros(2 * nb), np.full(2 * nl, -INF)])
    g_u = np.concatenate([np.zeros(1), np.zeros(2 * nb), rate2, rate2])
    pg0 = 0.5 * (case.gen_pmin + case.gen_pmax)
    qg0 = 0.5 * (case.gen_qmin + case.gen_qmax)
    x0 = np.concatenate([np.zeros(nb), np.ones(nb), pg0, qg0])
    x_l = np.concatenate([np.full(nb, -INF), case.bus_vmin, case.gen_pmin, case.gen_qmin])
    x_u = np.concatenate([np.full(nb, INF), case.bus_vmax, case.gen_pmax, case.gen_qmax])
    theta = (
        {"pd": np.asarray(case.bus_pd), "qd": np.asarray(case.bus_qd)}
        if scenario_batchable
        else None
    )
    if scenario_batchable:
        f_fn, g_fn = f, g
    else:
        f_fn, g_fn = (lambda x: f(x, None)), (lambda x: g(x, None))
    return NLP(
        f=f_fn,
        g=g_fn,
        n=n,
        m=m,
        x_l=x_l,
        x_u=x_u,
        g_l=g_l,
        g_u=g_u,
        x0=x0,
        num_linear=1,
        theta=theta,
        name=f"acopf_acp_{case.name}",
        structure=acopf_polar_structure(case),
    )


def acopf_polar_structure(case: PowerCase):
    """Exact structural sparsity of the polar formulation (row-wise variable
    supports), derived from the network topology.  Variable layout
    ``[va (nb), vm (nb), pg (ng), qg (ng)]``; row layout ``[ref angle,
    P balance (nb), Q balance (nb), s_from (nl), s_to (nl)]``."""
    from ..structure import NLPStructure

    nb, ng, nl = case.nb, case.ng, case.nl

    def va(i):
        return int(i)

    def vm(i):
        return int(nb + i)

    def pg(k):
        return int(2 * nb + k)

    def qg(k):
        return int(2 * nb + ng + k)

    nbr: list[set] = [set() for _ in range(nb)]
    for br in range(nl):
        f, t = int(case.br_f[br]), int(case.br_t[br])
        nbr[f].add(t)
        nbr[t].add(f)
    gens_at: list[list] = [[] for _ in range(nb)]
    for k, b in enumerate(case.gen_bus):
        gens_at[int(b)].append(k)

    rows = [np.array([va(case.ref_bus)])]
    for gen_var in (pg, qg):  # P balance, then Q balance
        for i in range(nb):
            cols = [va(i), vm(i)]
            for j in sorted(nbr[i]):
                cols += [va(j), vm(j)]
            cols += [gen_var(k) for k in gens_at[i]]
            rows.append(np.array(sorted(cols)))
    for _ in range(2):  # s_from, then s_to
        for br in range(nl):
            f, t = int(case.br_f[br]), int(case.br_t[br])
            rows.append(np.array(sorted({va(f), vm(f), va(t), vm(t)})))
    return NLPStructure(row_cols=tuple(rows))


def load_scenarios(case: PowerCase, batch: int, seed: int = 0, spread: float = 0.1):
    """Batch of load scenarios: multiplicative perturbations of (pd, qd).

    Returns a dict of numpy arrays with leading axis ``batch``, byte-identical
    to the JAX package's for the same arguments.
    """
    rng = np.random.default_rng(seed)
    scale = 1.0 + spread * (2.0 * rng.random((batch, 1)) - 1.0)
    jitter = 1.0 + 0.5 * spread * (2.0 * rng.random((batch, case.nb)) - 1.0)
    pd = case.bus_pd[None, :] * scale * jitter
    qd = case.bus_qd[None, :] * scale * jitter
    return {"pd": pd, "qd": qd}
