"""AC Optimal Power Flow as torch NLPs in four formulations.

Port of the JAX package's ``models/acopf.py``: polar (ACP, with piecewise-
linear cost epigraphs and HVDC lines), rectangular (ACR, the reference
example's own formulation), current-voltage (IVR) and lifted W-space (ACWR),
with the polar formulation's analytic sparsity (``acopf_polar_structure``,
for the block-structured KKT path) and ``load_scenarios``: minimize
generation cost subject to the reference-bus angle, bus balances and branch
thermal limits.  Loads (pd, qd) enter through the NLP ``theta`` dict, so one
solver runs a batch of load scenarios.

The JAX ``.at[idx].add`` scatters (branch flows, generation and HVDC
injections summed into their buses) become products with constant 0/1
incidence matrices: ``torch.func`` traces them, and they sum in a fixed
order.  ``index_add`` on a CUDA device sums with atomics in whatever order
the threads arrive, which made two runs of one solve differ in the last bit
of a bus balance and, many float32-factorized interior-point trips later, in
their trip counts and sometimes in where a lane stopped.  Gathers stay
gathers.  A model's constants are built once per (device, dtype) the first
time an evaluation meets them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLP
from .power import PowerCase

INF = np.inf


def _start_point(case: PowerCase):
    """Bound-midpoint generator start, per the reference's init_vars
    (examples/acopf/init_opf.jl:4-20)."""
    pg0 = 0.5 * (case.gen_pmin + case.gen_pmax)
    qg0 = 0.5 * (case.gen_qmin + case.gen_qmax)
    return pg0, qg0


def _require_plain(case: PowerCase, who: str):
    """PWL-cost / HVDC extensions are wired into the polar formulation only;
    the other formulations reject such cases loudly."""
    if case.n_pwl_gen or case.ndc:
        raise NotImplementedError(
            f"{who} does not support piecewise-linear costs or dclines; "
            "use acopf_polar for such cases"
        )


def _objective(case: PowerCase):
    """Polynomial generation cost ``sum(c2 MW^2 + c1 MW + c0)`` of ``pg``
    (p.u.), over the model's constants ``k``."""
    base = float(case.baseMVA)

    def cost(pg, k):
        mw = pg * base
        return torch.sum(k["c2"] * mw * mw + k["c1"] * mw + k["c0"])

    return cost


def _incidence(nb: int, idx) -> np.ndarray:
    """(nb, len(idx)) 0/1 matrix that sums entry ``j`` into bus ``idx[j]``."""
    idx = np.asarray(idx).reshape(-1)
    inc = np.zeros((nb, len(idx)))
    inc[idx, np.arange(len(idx))] = 1.0
    return inc


def _constants(floats: dict, indices: dict):
    """``const(ref)``: the numpy ``floats`` as tensors of ``ref``'s dtype and
    the ``indices`` as long tensors, on ``ref``'s device, built once per
    (device, dtype)."""
    cache = {}

    def const(ref: torch.Tensor) -> dict:
        key = (ref.device, ref.dtype)
        if key not in cache:
            fl = dict(dtype=ref.dtype, device=ref.device)
            ix = dict(dtype=torch.long, device=ref.device)
            cache[key] = {
                **{k: torch.as_tensor(v, **fl) for k, v in floats.items()},
                **{k: torch.as_tensor(v, **ix) for k, v in indices.items()},
            }
        return cache[key]

    return const


def _network(case: PowerCase):
    """The constants every formulation reads: branch admittances (8, nl) in
    ``gff bff gft bft gtf btf gtt btt`` order, incidence matrices of the
    generators and branch ends, shunts, loads and cost coefficients."""
    nb = case.nb
    floats = dict(
        adm=np.stack(case.admittances()),
        into_gen_bus=_incidence(nb, case.gen_bus),
        into_f=_incidence(nb, case.br_f),
        into_t=_incidence(nb, case.br_t),
        gs=case.bus_gs,
        bs=case.bus_bs,
        pd=case.bus_pd,
        qd=case.bus_qd,
        c2=case.cost_c2,
        c1=case.cost_c1,
        c0=case.cost_c0,
    )
    return floats, dict(f_idx=case.br_f, t_idx=case.br_t)


def _rate2(case: PowerCase) -> np.ndarray:
    """Squared thermal limits; an unrated branch gets 1e4."""
    has_rate = np.isfinite(case.br_rate) & (case.br_rate > 0)
    return np.where(has_rate, case.br_rate**2, 1.0e4)


def _loads(theta, k):
    return (theta["pd"], theta["qd"]) if theta is not None else (k["pd"], k["qd"])


def _make_nlp(case, f, g, scenario_batchable, **fields) -> NLP:
    """The NLP of one formulation; with ``scenario_batchable`` the loads are
    its ``theta``, else ``f`` and ``g`` read the case's own."""
    if scenario_batchable:
        theta = {"pd": np.asarray(case.bus_pd), "qd": np.asarray(case.bus_qd)}
        f_fn, g_fn = f, g
    else:
        theta = None
        f_fn, g_fn = (lambda x: f(x, None)), (lambda x: g(x, None))
    return NLP(f=f_fn, g=g_fn, theta=theta, **fields)


def acopf_polar(case: PowerCase, scenario_batchable: bool = True) -> NLP:
    """Polar (ACP) formulation.

    Variables  x = [va (nb), vm (nb), pg (ng), qg (ng)], plus, when the case
    carries them, piecewise-linear cost epigraph variables t (one per PWL
    generator) and HVDC line variables [pf, qf, qt] (the receiving-end
    active power is dependent: pt = (1-loss1)*pf - loss0, so no coupling row
    is needed -- MATPOWER dcline semantics).
    Rows (linear first): ref-bus angle; PWL epigraph segments
    (t_g >= slope*Pg_MW + icpt); P balance (nb); Q balance (nb); from/to
    thermal limits (2*nl).
    """
    nb, ng, nl, ndc = case.nb, case.ng, case.nl, case.ndc
    base = float(case.baseMVA)
    rate2 = _rate2(case)
    cost = _objective(case)
    floats, indices = _network(case)

    # PWL epigraph bookkeeping: one t variable per PWL generator, one linear
    # row per segment
    n_pwl = case.n_pwl_gen
    nseg = 0 if case.pwl_gen is None else len(case.pwl_gen)
    if n_pwl:
        pwl_gens = np.unique(case.pwl_gen)  # (n_pwl,) generator indices
        gen2t = {int(gi): j for j, gi in enumerate(pwl_gens)}
        indices.update(
            seg_t=np.asarray([gen2t[int(gi)] for gi in case.pwl_gen]),
            seg_gen=np.asarray(case.pwl_gen),
        )
        floats.update(seg_slope=np.asarray(case.pwl_slope))
    if ndc:
        floats.update(
            into_dcf=_incidence(nb, case.dc_f),
            into_dct=_incidence(nb, case.dc_t),
            loss0=case.dc_loss0,
            loss1=case.dc_loss1,
        )
    const = _constants(floats, indices)
    n = 2 * nb + 2 * ng + n_pwl + 3 * ndc
    o_extra = 2 * nb + 2 * ng

    def split(x):
        return x[:nb], x[nb : 2 * nb], x[2 * nb : 2 * nb + ng], x[2 * nb + ng : o_extra]

    def split_extra(x):
        """(t, dc_pf, dc_qf, dc_qt) -- the optional tail variables."""
        t = x[o_extra : o_extra + n_pwl]
        pf = x[o_extra + n_pwl : o_extra + n_pwl + ndc]
        qf = x[o_extra + n_pwl + ndc : o_extra + n_pwl + 2 * ndc]
        qt = x[o_extra + n_pwl + 2 * ndc :]
        return t, pf, qf, qt

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
        val = cost(split(x)[2], k)
        if n_pwl:
            val = val + torch.sum(split_extra(x)[0])
        return val

    def g(x, theta=None):
        k = const(x)
        va, vm, pg, qg = split(x)
        pd, qd = _loads(theta, k)
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
        rows_lin = [x[case.ref_bus : case.ref_bus + 1]]
        if n_pwl:
            t = split_extra(x)[0]
            rows_lin.append(t[k["seg_t"]] - k["seg_slope"] * base * pg[k["seg_gen"]])
        if ndc:
            _, dpf, dqf, dqt = split_extra(x)
            dpt = (1.0 - k["loss1"]) * dpf - k["loss0"]
            p_inj = p_inj - k["into_dcf"] @ dpf + k["into_dct"] @ dpt
            q_inj = q_inj + k["into_dcf"] @ dqf + k["into_dct"] @ dqt
        s_from = p_f * p_f + q_f * q_f
        s_to = p_t * p_t + q_t * q_t
        return torch.cat(rows_lin + [p_inj, q_inj, s_from, s_to])

    m = 1 + nseg + 2 * nb + 2 * nl
    g_l = np.concatenate([
        np.zeros(1),
        np.asarray(case.pwl_icpt) if nseg else np.zeros(0),
        np.zeros(2 * nb),
        np.full(2 * nl, -INF),
    ])
    g_u = np.concatenate([np.zeros(1), np.full(nseg, INF), np.zeros(2 * nb), rate2, rate2])
    pg0, qg0 = _start_point(case)
    x0 = np.concatenate([np.zeros(nb), np.ones(nb), pg0, qg0])
    x_l = np.concatenate([np.full(nb, -INF), case.bus_vmin, case.gen_pmin, case.gen_qmin])
    x_u = np.concatenate([np.full(nb, INF), case.bus_vmax, case.gen_pmax, case.gen_qmax])
    if n_pwl:
        # start each epigraph variable on its PWL curve at pg0 (feasible)
        mw0 = pg0[pwl_gens] * case.baseMVA
        t0 = np.full(n_pwl, -np.inf)
        for s in range(nseg):
            j = int(np.searchsorted(pwl_gens, case.pwl_gen[s]))
            t0[j] = max(t0[j], case.pwl_slope[s] * mw0[j] + case.pwl_icpt[s])
        x0 = np.concatenate([x0, t0])
        x_l = np.concatenate([x_l, np.full(n_pwl, -INF)])
        x_u = np.concatenate([x_u, np.full(n_pwl, INF)])
    if ndc:
        x0 = np.concatenate([
            x0,
            0.5 * (case.dc_pmin + case.dc_pmax),
            0.5 * (case.dc_qminf + case.dc_qmaxf),
            0.5 * (case.dc_qmint + case.dc_qmaxt),
        ])
        x_l = np.concatenate([x_l, case.dc_pmin, case.dc_qminf, case.dc_qmint])
        x_u = np.concatenate([x_u, case.dc_pmax, case.dc_qmaxf, case.dc_qmaxt])
    return _make_nlp(
        case, f, g, scenario_batchable,
        n=n, m=m, x_l=x_l, x_u=x_u, g_l=g_l, g_u=g_u, x0=x0,
        num_linear=1 + nseg,
        name=f"acopf_acp_{case.name}",
        # the BBD structure map covers the plain [va,vm,pg,qg] layout; cases
        # with PWL epigraph / HVDC tail variables take the dense path
        structure=None if (n_pwl or ndc) else acopf_polar_structure(case),
    )


def acopf_rect(case: PowerCase, scenario_batchable: bool = True) -> NLP:
    """Rectangular (ACR) formulation -- the reference example's formulation
    (``examples/acopf/opf.jl:52`` uses build_acr).

    Variables  x = [vr (nb), vi (nb), pg (ng), qg (ng)]; voltage magnitude
    bounds become nonlinear rows  vmin^2 <= vr^2 + vi^2 <= vmax^2
    (PowerModels constraint_voltage_magnitude semantics), after the
    balances.  Rows: ref-bus vi (the one linear row); P balance (nb);
    Q balance (nb); voltage magnitude (nb); from/to thermal limits (2*nl).
    """
    _require_plain(case, "acopf_rect")
    nb, ng, nl = case.nb, case.ng, case.nl
    rate2 = _rate2(case)
    cost = _objective(case)
    const = _constants(*_network(case))
    n = 2 * nb + 2 * ng

    def split(x):
        return x[:nb], x[nb : 2 * nb], x[2 * nb : 2 * nb + ng], x[2 * nb + ng :]

    def f(x, theta=None):
        return cost(split(x)[2], const(x))

    def g(x, theta=None):
        k = const(x)
        vr, vi, pg, qg = split(x)
        pd, qd = _loads(theta, k)
        Gff, Bff, Gft, Bft, Gtf, Btf, Gtt, Btt = k["adm"]
        vrf, vrt = vr[k["f_idx"]], vr[k["t_idx"]]
        vif, vit = vi[k["f_idx"]], vi[k["t_idx"]]
        vf2 = vrf * vrf + vif * vif
        vt2 = vrt * vrt + vit * vit
        A = vrf * vrt + vif * vit  # Re(V_f conj(V_t))
        B = vif * vrt - vrf * vit  # Im(V_f conj(V_t))
        p_f = Gff * vf2 + Gft * A + Bft * B
        q_f = -Bff * vf2 - Bft * A + Gft * B
        p_t = Gtt * vt2 + Gtf * A - Btf * B
        q_t = -Btt * vt2 - Btf * A - Gtf * B
        v2 = vr * vr + vi * vi
        p_inj = (
            k["into_gen_bus"] @ pg
            - pd
            - k["gs"] * v2
            - k["into_f"] @ p_f
            - k["into_t"] @ p_t
        )
        q_inj = (
            k["into_gen_bus"] @ qg
            - qd
            + k["bs"] * v2
            - k["into_f"] @ q_f
            - k["into_t"] @ q_t
        )
        s_from = p_f * p_f + q_f * q_f
        s_to = p_t * p_t + q_t * q_t
        ref = vi[case.ref_bus : case.ref_bus + 1]
        return torch.cat([ref, p_inj, q_inj, v2, s_from, s_to])

    m = 1 + 2 * nb + nb + 2 * nl
    g_l = np.concatenate([np.zeros(1), np.zeros(2 * nb), case.bus_vmin**2, np.full(2 * nl, -INF)])
    g_u = np.concatenate([np.zeros(1), np.zeros(2 * nb), case.bus_vmax**2, rate2, rate2])
    pg0, qg0 = _start_point(case)
    x0 = np.concatenate([np.ones(nb), np.zeros(nb), pg0, qg0])
    x_l = np.concatenate([np.full(nb, -INF), np.full(nb, -INF), case.gen_pmin, case.gen_qmin])
    x_u = np.concatenate([np.full(nb, INF), np.full(nb, INF), case.gen_pmax, case.gen_qmax])
    return _make_nlp(
        case, f, g, scenario_batchable,
        n=n, m=m, x_l=x_l, x_u=x_u, g_l=g_l, g_u=g_u, x0=x0,
        num_linear=1, name=f"acopf_acr_{case.name}",
    )


def acopf_ivr(case: PowerCase, scenario_batchable: bool = True) -> NLP:
    """Current-voltage rectangular (IVR) formulation (PowerModels'
    build_opf_iv semantics; the reference initializes an ``IVRPowerModel``
    in ``examples/acopf/init_opf.jl:53-183``).

    Variables  x = [vr (nb), vi (nb), crg (ng), cig (ng)] -- rectangular
    voltages plus rectangular GENERATOR current injections.  Branch currents
    are linear expressions  I_f = Y_ff V_f + Y_ft V_t  (substituted, not
    lifted), generator power is the bilinear expression ``S_g = V conj(I_g)``,
    and the bus *current* balance carries the constant-power loads as the
    rational  I_d = conj(S_d / V).  Rows (linear first): ref-bus vi; current
    balance (2 nb); generator P/Q windows on the bilinear expressions
    (2 ng); voltage magnitude (nb); thermal limits as the quartic
    ``|V_f|^2 |I_f|^2 <= rate^2`` (2 nl).
    """
    _require_plain(case, "acopf_ivr")
    nb, ng, nl = case.nb, case.ng, case.nl
    rate2 = _rate2(case)
    cost = _objective(case)
    floats, indices = _network(case)
    indices.update(gen_bus=case.gen_bus)
    const = _constants(floats, indices)
    n = 2 * nb + 2 * ng

    def split(x):
        return x[:nb], x[nb : 2 * nb], x[2 * nb : 2 * nb + ng], x[2 * nb + ng :]

    def gen_power(vr, vi, crg, cig, k):
        vrg = vr[k["gen_bus"]]
        vig = vi[k["gen_bus"]]
        pg = vrg * crg + vig * cig  # Re  V conj(I_g)
        qg = vig * crg - vrg * cig  # Im  V conj(I_g)
        return pg, qg

    def f(x, theta=None):
        k = const(x)
        return cost(gen_power(*split(x), k)[0], k)

    def g(x, theta=None):
        k = const(x)
        vr, vi, crg, cig = split(x)
        pd, qd = _loads(theta, k)
        Gff, Bff, Gft, Bft, Gtf, Btf, Gtt, Btt = k["adm"]
        vrf, vrt = vr[k["f_idx"]], vr[k["t_idx"]]
        vif, vit = vi[k["f_idx"]], vi[k["t_idx"]]
        # branch terminal currents, LINEAR in v:  I_f = Yff Vf + Yft Vt,
        # I_t = Ytt Vt + Ytf Vf
        cr_f = Gff * vrf - Bff * vif + Gft * vrt - Bft * vit
        ci_f = Gff * vif + Bff * vrf + Gft * vit + Bft * vrt
        cr_t = Gtt * vrt - Btt * vit + Gtf * vrf - Btf * vif
        ci_t = Gtt * vit + Btt * vrt + Gtf * vif + Btf * vrf
        v2 = vr * vr + vi * vi
        # load current  I_d = conj(S_d / V) = (S_d^* V) / |V|^2
        ird = (pd * vr + qd * vi) / v2
        iid = (pd * vi - qd * vr) / v2
        # shunt current  (gs + j bs) V
        irs = k["gs"] * vr - k["bs"] * vi
        iis = k["gs"] * vi + k["bs"] * vr
        bal_r = (
            k["into_gen_bus"] @ crg
            - ird
            - irs
            - k["into_f"] @ cr_f
            - k["into_t"] @ cr_t
        )
        bal_i = (
            k["into_gen_bus"] @ cig
            - iid
            - iis
            - k["into_f"] @ ci_f
            - k["into_t"] @ ci_t
        )
        pg, qg = gen_power(vr, vi, crg, cig, k)
        vf2 = vrf * vrf + vif * vif
        vt2 = vrt * vrt + vit * vit
        s_from = vf2 * (cr_f * cr_f + ci_f * ci_f)  # == |S_f|^2
        s_to = vt2 * (cr_t * cr_t + ci_t * ci_t)
        ref = vi[case.ref_bus : case.ref_bus + 1]
        return torch.cat([ref, bal_r, bal_i, pg, qg, v2, s_from, s_to])

    m = 1 + 2 * nb + 2 * ng + nb + 2 * nl
    g_l = np.concatenate([
        np.zeros(1), np.zeros(2 * nb), case.gen_pmin, case.gen_qmin, case.bus_vmin**2,
        np.full(2 * nl, -INF),
    ])
    g_u = np.concatenate([
        np.zeros(1), np.zeros(2 * nb), case.gen_pmax, case.gen_qmax, case.bus_vmax**2,
        rate2, rate2,
    ])
    pg0, qg0 = _start_point(case)
    # flat voltage start V = 1 + 0j  =>  I_g = conj(S_g / V) = pg0 - j qg0
    x0 = np.concatenate([np.ones(nb), np.zeros(nb), pg0, -qg0])
    return _make_nlp(
        case, f, g, scenario_batchable,
        n=n, m=m, x_l=np.full(n, -INF), x_u=np.full(n, INF), g_l=g_l, g_u=g_u, x0=x0,
        num_linear=1, name=f"acopf_ivr_{case.name}",
    )


def _bus_pairs(case: PowerCase):
    """Canonical bus pairs (lo < hi, one per connected pair: parallel
    branches share one), each branch's pair, and its orientation (+1 if
    (f, t) is (lo, hi)).  ``np.unique``'s inverse changed shape between numpy
    releases, hence the reshape."""
    f_idx = np.asarray(case.br_f)
    t_idx = np.asarray(case.br_t)
    pair_lo = np.minimum(f_idx, t_idx)
    pair_hi = np.maximum(f_idx, t_idx)
    pairs, br_pair = np.unique(np.stack([pair_lo, pair_hi], axis=1), axis=0, return_inverse=True)
    return pairs, br_pair.reshape(-1), np.where(f_idx == pair_lo, 1.0, -1.0)


def acopf_wr(case: PowerCase, scenario_batchable: bool = True) -> NLP:
    """W-space rectangular (ACWR) formulation (the reference's custom
    ``ACWRPowerModel``, examples/acopf/acwr.jl:22-35).

    Lifted variables ``w_i = vr_i^2 + vi_i^2`` per bus and
    ``wr_ij = vr_i vr_j + vi_i vi_j``, ``wi_ij = vi_i vr_j - vr_i vi_j`` per
    bus pair make the power-flow rows *linear* in (w, wr, wi, pg, qg); only
    the lifting constraints and thermal limits stay nonlinear.  Variable
    layout: x = [vr, vi (nb each), w (nb), wr, wi (npairs each), pg, qg].
    Rows (linear first): ref-bus vi, P and Q balance (2 nb); lifting rows
    (nb + 2 npairs); from/to thermal limits (2 nl).
    """
    _require_plain(case, "acopf_wr")
    if np.any(case.br_tap != 1.0) or np.any(case.br_shift != 0.0):
        raise ValueError("acopf_wr supports tap=1, shift=0 branches only")
    nb, ng, nl = case.nb, case.ng, case.nl
    rate2 = _rate2(case)
    cost = _objective(case)
    pairs, br_pair, orient = _bus_pairs(case)
    npair = len(pairs)
    floats, indices = _network(case)
    floats.update(orient=orient)
    indices.update(br_pair=br_pair, plo=pairs[:, 0], phi=pairs[:, 1])
    const = _constants(floats, indices)
    n = 3 * nb + 2 * npair + 2 * ng
    o_g = 3 * nb + 2 * npair

    def split(x):
        vr = x[:nb]
        vi = x[nb : 2 * nb]
        w = x[2 * nb : 3 * nb]
        wr = x[3 * nb : 3 * nb + npair]
        wi = x[3 * nb + npair : o_g]
        return vr, vi, w, wr, wi, x[o_g : o_g + ng], x[o_g + ng :]

    def f(x, theta=None):
        return cost(split(x)[5], const(x))

    def g(x, theta=None):
        k = const(x)
        vr, vi, w, wr, wi, pg, qg = split(x)
        pd, qd = _loads(theta, k)
        Gff, Bff, Gft, Bft, Gtf, Btf, Gtt, Btt = k["adm"]
        wr_b = wr[k["br_pair"]]
        wi_b = wi[k["br_pair"]] * k["orient"]
        wf = w[k["f_idx"]]
        wt = w[k["t_idx"]]
        # branch flows, linear in (w, wr, wi)
        p_f = Gff * wf + Gft * wr_b + Bft * wi_b
        q_f = -Bff * wf - Bft * wr_b + Gft * wi_b
        p_t = Gtt * wt + Gtf * wr_b - Btf * wi_b
        q_t = -Btt * wt - Btf * wr_b - Gtf * wi_b
        p_inj = (
            k["into_gen_bus"] @ pg
            - pd
            - k["gs"] * w
            - k["into_f"] @ p_f
            - k["into_t"] @ p_t
        )
        q_inj = (
            k["into_gen_bus"] @ qg
            - qd
            + k["bs"] * w
            - k["into_f"] @ q_f
            - k["into_t"] @ q_t
        )
        # nonlinear lifting rows (acwr.jl:28-34)
        lo, hi = k["plo"], k["phi"]
        link_w = w - (vr * vr + vi * vi)
        link_wr = wr - (vr[lo] * vr[hi] + vi[lo] * vi[hi])
        link_wi = wi - (vi[lo] * vr[hi] - vr[lo] * vi[hi])
        s_from = p_f * p_f + q_f * q_f
        s_to = p_t * p_t + q_t * q_t
        ref = vi[case.ref_bus : case.ref_bus + 1]  # linear: ref angle
        return torch.cat([ref, p_inj, q_inj, link_w, link_wr, link_wi, s_from, s_to])

    m = 1 + 2 * nb + nb + 2 * npair + 2 * nl
    g_l = np.concatenate([np.zeros(1 + 2 * nb), np.zeros(nb + 2 * npair), np.full(2 * nl, -INF)])
    g_u = np.concatenate([np.zeros(1 + 2 * nb), np.zeros(nb + 2 * npair), rate2, rate2])
    pg0, qg0 = _start_point(case)
    x0 = np.concatenate([
        np.ones(nb), np.zeros(nb), np.ones(nb), np.ones(npair), np.zeros(npair), pg0, qg0,
    ])
    pair_wmax = case.bus_vmax[pairs[:, 0]] * case.bus_vmax[pairs[:, 1]]
    x_l = np.concatenate([
        np.full(nb, -INF), np.full(nb, -INF), case.bus_vmin**2, -pair_wmax, -pair_wmax,
        case.gen_pmin, case.gen_qmin,
    ])
    x_u = np.concatenate([
        np.full(nb, INF), np.full(nb, INF), case.bus_vmax**2, pair_wmax, pair_wmax,
        case.gen_pmax, case.gen_qmax,
    ])
    return _make_nlp(
        case, f, g, scenario_batchable,
        n=n, m=m, x_l=x_l, x_u=x_u, g_l=g_l, g_u=g_u, x0=x0,
        num_linear=1 + 2 * nb, name=f"acopf_wr_{case.name}",
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
