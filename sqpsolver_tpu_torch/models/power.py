"""Power-network data model: the pure-data replacement for PowerModels.jl.

The reference's flagship workload builds ACOPF via PowerModels + JuMP
(SqpSolver.jl ``test/opf.jl:5-9``, ``examples/acopf/opf.jl:12-43``).  Here
the network is a plain arrays-of-records structure (MATPOWER-style columns)
and the OPF formulations in :mod:`sqpsolver_tpu_torch.models.acopf` are pure torch
functions over it — the *math* of the reference's build_opf is ported, not the
package.

Includes the WSCC 9-bus test system (standard public engineering data, the
``case9`` the reference scripts reference at ``examples/acopf/opf.jl:84``) and
a seeded synthetic-network generator for arbitrary-size benchmark cases
(case118-scale and beyond) since MATPOWER data files are not vendored here
(the reference vendors only case3, SURVEY §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerCase:
    """A power network in per-unit, MATPOWER-like column arrays."""

    name: str
    baseMVA: float
    # bus arrays, length nb
    bus_pd: np.ndarray  # active load (p.u.)
    bus_qd: np.ndarray  # reactive load (p.u.)
    bus_gs: np.ndarray  # shunt conductance (p.u.)
    bus_bs: np.ndarray  # shunt susceptance (p.u.)
    bus_vmin: np.ndarray
    bus_vmax: np.ndarray
    ref_bus: int
    # generator arrays, length ng
    gen_bus: np.ndarray  # bus index of each generator
    gen_pmin: np.ndarray
    gen_pmax: np.ndarray
    gen_qmin: np.ndarray
    gen_qmax: np.ndarray
    # polynomial cost  c2*Pg^2 + c1*Pg + c0  with Pg in MW
    cost_c2: np.ndarray
    cost_c1: np.ndarray
    cost_c0: np.ndarray
    # branch arrays, length nl
    br_f: np.ndarray  # from-bus index
    br_t: np.ndarray  # to-bus index
    br_r: np.ndarray
    br_x: np.ndarray
    br_b: np.ndarray  # total line charging susceptance
    br_tap: np.ndarray  # tap ratio (1.0 = none)
    br_shift: np.ndarray  # phase shift (radians)
    br_rate: np.ndarray  # thermal limit (p.u.; 0/inf = unlimited)

    # -- piecewise-linear generator costs (MATPOWER gencost model 1),
    # converted to max-of-affine segments and flattened: segment s belongs to
    # generator pwl_gen[s] with cost >= pwl_slope[s]*Pg_MW + pwl_icpt[s].
    # Generators carrying segments have cost_c2=c1=c0=0.  None = none.
    pwl_gen: np.ndarray | None = None  # (nseg,) generator index
    pwl_slope: np.ndarray | None = None  # (nseg,) $/MWh
    pwl_icpt: np.ndarray | None = None  # (nseg,) $

    # -- HVDC lines (MATPOWER mpc.dcline), per-unit.  The receiving-end
    # power is dependent: pt = (1 - loss1)*pf - loss0.  None = none.
    dc_f: np.ndarray | None = None  # (ndc,) from-bus index
    dc_t: np.ndarray | None = None  # (ndc,) to-bus index
    dc_pmin: np.ndarray | None = None  # bounds on pf
    dc_pmax: np.ndarray | None = None
    dc_qminf: np.ndarray | None = None  # reactive bounds at the from end
    dc_qmaxf: np.ndarray | None = None
    dc_qmint: np.ndarray | None = None  # ... and the to end
    dc_qmaxt: np.ndarray | None = None
    dc_loss0: np.ndarray | None = None  # p.u. constant loss
    dc_loss1: np.ndarray | None = None  # marginal loss (fraction of pf)

    @property
    def nb(self) -> int:
        return len(self.bus_pd)

    @property
    def ng(self) -> int:
        return len(self.gen_bus)

    @property
    def nl(self) -> int:
        return len(self.br_f)

    @property
    def ndc(self) -> int:
        return 0 if self.dc_f is None else len(self.dc_f)

    @property
    def n_pwl_gen(self) -> int:
        return (
            0 if self.pwl_gen is None else len(np.unique(self.pwl_gen))
        )

    def admittances(self):
        """Branch admittance four-tuples (gff,bff,gft,bft,gtf,btf,gtt,btt)
        in the standard MATPOWER pi-model convention."""
        ys = 1.0 / (self.br_r + 1j * self.br_x)
        bc2 = 1j * self.br_b / 2.0
        tap = self.br_tap * np.exp(1j * self.br_shift)
        yff = (ys + bc2) / (tap * np.conj(tap))
        yft = -ys / np.conj(tap)
        ytf = -ys / tap
        ytt = ys + bc2
        return (
            yff.real, yff.imag, yft.real, yft.imag,
            ytf.real, ytf.imag, ytt.real, ytt.imag,
        )


def case9() -> PowerCase:
    """WSCC 3-machine 9-bus system (per-unit on 100 MVA)."""
    nb = 9
    pd = np.zeros(nb)
    qd = np.zeros(nb)
    pd[[4, 6, 8]] = np.array([90.0, 100.0, 125.0]) / 100.0
    qd[[4, 6, 8]] = np.array([30.0, 35.0, 50.0]) / 100.0
    br = np.array(
        [
            # f, t, r, x, b, rate (MVA)
            [1, 4, 0.0, 0.0576, 0.0, 250.0],
            [4, 5, 0.017, 0.092, 0.158, 250.0],
            [5, 6, 0.039, 0.17, 0.358, 150.0],
            [3, 6, 0.0, 0.0586, 0.0, 300.0],
            [6, 7, 0.0119, 0.1008, 0.209, 150.0],
            [7, 8, 0.0085, 0.072, 0.149, 250.0],
            [8, 2, 0.0, 0.0625, 0.0, 250.0],
            [8, 9, 0.032, 0.161, 0.306, 250.0],
            [9, 4, 0.01, 0.085, 0.176, 250.0],
        ]
    )
    return PowerCase(
        name="case9",
        baseMVA=100.0,
        bus_pd=pd,
        bus_qd=qd,
        bus_gs=np.zeros(nb),
        bus_bs=np.zeros(nb),
        bus_vmin=np.full(nb, 0.9),
        bus_vmax=np.full(nb, 1.1),
        ref_bus=0,
        gen_bus=np.array([0, 1, 2]),
        gen_pmin=np.array([0.1, 0.1, 0.1]),
        gen_pmax=np.array([2.5, 3.0, 2.7]),
        gen_qmin=np.array([-3.0, -3.0, -3.0]),
        gen_qmax=np.array([3.0, 3.0, 3.0]),
        cost_c2=np.array([0.11, 0.085, 0.1225]),
        cost_c1=np.array([5.0, 1.2, 1.0]),
        cost_c0=np.array([150.0, 600.0, 335.0]),
        br_f=br[:, 0].astype(int) - 1,
        br_t=br[:, 1].astype(int) - 1,
        br_r=br[:, 2],
        br_x=br[:, 3],
        br_b=br[:, 4],
        br_tap=np.ones(9),
        br_shift=np.zeros(9),
        br_rate=br[:, 5] / 100.0,
    )


def synthetic_case(nb: int, seed: int = 0, name: str | None = None) -> PowerCase:
    """Seeded synthetic transmission network of ``nb`` buses.

    Ring backbone + random chords (~1.5 branches/bus), generators on ~25% of
    buses with ample capacity, loads sized for comfortable feasibility —
    intended for *performance* benchmarking at case118/case300/case2869 scale
    (BASELINE.md configs) where the real MATPOWER data is not vendored.
    """
    rng = np.random.default_rng(seed)
    # ring + chords
    f = list(range(nb))
    t = [(i + 1) % nb for i in range(nb)]
    n_chord = max(nb // 2, 1)
    cf = rng.integers(0, nb, n_chord)
    ct = (cf + rng.integers(2, max(nb // 2, 3), n_chord)) % nb
    keep = cf != ct
    f = np.array(f + list(cf[keep]))
    t = np.array(t + list(ct[keep]))
    nl = len(f)

    x = rng.uniform(0.05, 0.2, nl)
    r = x * rng.uniform(0.05, 0.3, nl)
    b = rng.uniform(0.0, 0.08, nl)

    ngen = max(2, nb // 4)
    gen_bus = rng.choice(nb, ngen, replace=False)
    gen_bus.sort()

    pd = rng.uniform(0.0, 0.6, nb)
    pd[gen_bus] *= 0.3
    qd = pd * rng.uniform(0.2, 0.4, nb)
    total_load = pd.sum()

    pmax = np.full(ngen, 2.5 * total_load / ngen)
    case = PowerCase(
        name=name or f"synth{nb}",
        baseMVA=100.0,
        bus_pd=pd,
        bus_qd=qd,
        bus_gs=np.zeros(nb),
        bus_bs=np.zeros(nb),
        bus_vmin=np.full(nb, 0.9),
        bus_vmax=np.full(nb, 1.1),
        ref_bus=int(gen_bus[0]),
        gen_bus=gen_bus,
        gen_pmin=np.zeros(ngen),
        gen_pmax=pmax,
        gen_qmin=np.full(ngen, -1.5 * total_load / ngen),
        gen_qmax=np.full(ngen, 1.5 * total_load / ngen),
        cost_c2=rng.uniform(0.05, 0.15, ngen),
        cost_c1=rng.uniform(1.0, 6.0, ngen),
        cost_c0=np.zeros(ngen),
        br_f=f,
        br_t=t,
        br_r=r,
        br_x=x,
        br_b=b,
        br_tap=np.ones(nl),
        br_shift=np.zeros(nl),
        # generous thermal limits: 2x the load share per branch, floor 1 p.u.
        br_rate=np.maximum(2.0 * total_load / np.sqrt(nl), 1.0) * np.ones(nl),
    )
    return case


def replicate_case(
    case: PowerCase, k: int, tie_x: float = 0.25, name: str | None = None
) -> PowerCase:
    """``k`` interconnected copies of a validated real network.

    Real MATPOWER data above 30 buses is not vendored in this repository
    (the reference itself vendors only case3, SqpSolver.jl
    ``examples/acopf/case3.m``), so large *real-physics*
    regression cases are built by replication: each copy keeps the original's
    exact impedances/limits/costs, copies are chained by one weak tie line
    (reactance ``tie_x``, no rating) between copy i's reference bus and copy
    i+1's highest-numbered bus.  With identical copies and symmetric costs
    the optimum stays close to ``k *`` the single-case optimum (ties carry
    ~zero flow at the optimum) — and tests verify the optimum independently
    against scipy SLSQP on the full replicated network
    (tests/test_acopf.py).
    """
    nb, ng, nl = case.nb, case.ng, case.nl

    def tile(a, n=nb):
        return np.concatenate([a for _ in range(k)])

    def tile_idx(a, n=nb):
        return np.concatenate([a + i * n for i in range(k)])

    tie_f = np.array([case.ref_bus + i * nb for i in range(k - 1)])
    tie_t = np.array([(nb - 1) + (i + 1) * nb for i in range(k - 1)])
    nt = k - 1
    extras = {}
    if case.pwl_gen is not None:
        extras["pwl_gen"] = tile_idx(case.pwl_gen, ng)
        extras["pwl_slope"] = tile(case.pwl_slope)
        extras["pwl_icpt"] = tile(case.pwl_icpt)
    if case.dc_f is not None:
        extras["dc_f"] = tile_idx(case.dc_f)
        extras["dc_t"] = tile_idx(case.dc_t)
        for fld in (
            "dc_pmin", "dc_pmax", "dc_qminf", "dc_qmaxf", "dc_qmint",
            "dc_qmaxt", "dc_loss0", "dc_loss1",
        ):
            extras[fld] = tile(getattr(case, fld))
    return PowerCase(
        **extras,
        name=name or f"{case.name}x{k}",
        baseMVA=case.baseMVA,
        bus_pd=tile(case.bus_pd),
        bus_qd=tile(case.bus_qd),
        bus_gs=tile(case.bus_gs),
        bus_bs=tile(case.bus_bs),
        bus_vmin=tile(case.bus_vmin),
        bus_vmax=tile(case.bus_vmax),
        ref_bus=case.ref_bus,
        gen_bus=tile_idx(case.gen_bus),
        gen_pmin=tile(case.gen_pmin),
        gen_pmax=tile(case.gen_pmax),
        gen_qmin=tile(case.gen_qmin),
        gen_qmax=tile(case.gen_qmax),
        cost_c2=tile(case.cost_c2),
        cost_c1=tile(case.cost_c1),
        cost_c0=tile(case.cost_c0),
        br_f=np.concatenate([tile_idx(case.br_f), tie_f]),
        br_t=np.concatenate([tile_idx(case.br_t), tie_t]),
        br_r=np.concatenate([tile(case.br_r), np.full(nt, 0.02)]),
        br_x=np.concatenate([tile(case.br_x), np.full(nt, tie_x)]),
        br_b=np.concatenate([tile(case.br_b), np.zeros(nt)]),
        br_tap=np.concatenate([tile(case.br_tap), np.ones(nt)]),
        br_shift=np.concatenate([tile(case.br_shift), np.zeros(nt)]),
        br_rate=np.concatenate(
            [tile(case.br_rate), np.zeros(nt)]  # ties unrated
        ),
    )
