"""Plain reference for the polar AC optimal power flow: its own MATPOWER
reader, the model, a primal-dual interior-point solve of every scenario
handed to it, and the judge of the program's answers.

Nothing here comes from the program: the case file is read afresh, the
network matrices are built from MATPOWER's branch model (Zimmerman et al.,
"MATPOWER: Steady-State Operations, Planning and Analysis Tools", IEEE
Trans. Power Systems 26(1), 2011, section III), derivatives come from
``torch.func`` on that model, and the solver is MATPOWER's interior-point
method (MIPS, Wang et al., "On Computational Issues of Market-Based Optimal
Power Flow", IEEE Trans. Power Systems 22(3), 2007), written out plainly,
batched over scenarios, in float64 on the CPU.

The problem, as the configuration states it (``acopf_polar``):

    x = [va (nb), vm (nb), pg (ng), qg (ng)]   (radians, p.u.)
    min  sum_g c2 (100 pg)^2 + c1 (100 pg) + c0          (MW on baseMVA)
    s.t. va[ref] = 0
         Re/Im( Cg (pg + j qg) - (pd + j qd) - V conj(Ybus V) ) = 0   (nb each)
         |Sf|^2 <= rate^2,  |St|^2 <= rate^2                            (nl each)
         vmin <= vm <= vmax,  pmin <= pg <= pmax,  qmin <= qg <= qmax

with the rows in that order.  Multipliers follow the sign convention in
which  grad f + J' lam + nu_U - nu_L = 0  at a solution: the one the
program reports, so the two are compared row by row.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch.func import vmap

SOLVED = (0, 1, 6)  # the statuses a solve reports as solved
OPTIMAL = (0, 1)  # those that claim a KKT point (6 claims a feasible one)


# --------------------------------------------------------------- case file ---
def _matrix(text: str, name: str) -> np.ndarray:
    body = re.search(rf"mpc\.{name}\s*=\s*\[(.*?)\];", text, re.S).group(1)
    rows = []
    for line in body.splitlines():
        line = line.split("%")[0].strip().rstrip(";").strip()
        if line:
            rows.append([float(v) for v in line.replace(";", " ").split()])
    return np.array(rows)


@dataclasses.dataclass(frozen=True)
class Network:
    """The numbers of one MATPOWER case, per unit, in-service rows only."""

    base: float
    pd: np.ndarray
    qd: np.ndarray
    vmin: np.ndarray
    vmax: np.ndarray
    ref: int
    gen_bus: np.ndarray
    pmin: np.ndarray
    pmax: np.ndarray
    qmin: np.ndarray
    qmax: np.ndarray
    cost: np.ndarray  # (ng, 3): c2, c1, c0 on MW
    Ybus: np.ndarray  # (nb, nb) complex
    Yf: np.ndarray  # (nl, nb) complex
    Yt: np.ndarray
    f: np.ndarray
    t: np.ndarray
    rate2: np.ndarray  # (nl,) squared limits, p.u.^2

    @property
    def nb(self):
        return len(self.pd)

    @property
    def ng(self):
        return len(self.gen_bus)

    @property
    def nl(self):
        return len(self.f)

    @property
    def n(self):
        return 2 * self.nb + 2 * self.ng

    @property
    def m(self):
        return 1 + 2 * self.nb + 2 * self.nl


def read_case(path: str) -> Network:
    """A MATPOWER version-2 case with polynomial costs of degree <= 2."""
    with open(path) as fh:
        text = fh.read()
    base = float(re.search(r"mpc\.baseMVA\s*=\s*([0-9.eE+-]+)", text).group(1))
    bus, gen, br, gc = (_matrix(text, k) for k in ("bus", "gen", "branch", "gencost"))
    gc = gc[: len(gen)]
    on = gen[:, 7] > 0
    gen, gc = gen[on], gc[on]
    br = br[br[:, 10] > 0]
    idx = {int(b): i for i, b in enumerate(bus[:, 0])}
    nb = len(bus)
    if np.any(gc[:, 0] != 2) or np.any(gc[:, 3] > 3):
        raise ValueError("the reference takes polynomial costs of degree <= 2")
    cost = np.zeros((len(gen), 3))
    for i, row in enumerate(gc):
        k = int(row[3])
        cost[i, 3 - k :] = row[4 : 4 + k]
    f = np.array([idx[int(b)] for b in br[:, 0]])
    t = np.array([idx[int(b)] for b in br[:, 1]])
    # MATPOWER's pi model: series admittance, half the charging at each end,
    # an off-nominal tap (0 = 1) with phase shift on the from side
    ys = 1.0 / (br[:, 2] + 1j * br[:, 3])
    bc = br[:, 4]
    tap = np.where(br[:, 8] == 0, 1.0, br[:, 8]) * np.exp(1j * np.deg2rad(br[:, 9]))
    ytt = ys + 0.5j * bc
    yff = ytt / (tap * np.conj(tap))
    yft = -ys / np.conj(tap)
    ytf = -ys / tap
    nl = len(br)
    Cf = np.zeros((nl, nb))
    Ct = np.zeros((nl, nb))
    Cf[np.arange(nl), f] = 1.0
    Ct[np.arange(nl), t] = 1.0
    Yf = yff[:, None] * Cf + yft[:, None] * Ct
    Yt = ytf[:, None] * Cf + ytt[:, None] * Ct
    Ysh = (bus[:, 4] + 1j * bus[:, 5]) / base
    Ybus = Cf.T @ Yf + Ct.T @ Yt + np.diag(Ysh)
    rate = br[:, 5] / base
    # an unrated branch (RATE_A = 0) keeps its row with the limit 1e4 p.u.^2,
    # as the formulation states
    rate2 = np.where(rate > 0, rate**2, 1.0e4)
    ref = int(np.where(bus[:, 1] == 3)[0][0])
    return Network(
        base=base, pd=bus[:, 2] / base, qd=bus[:, 3] / base,
        vmin=bus[:, 12], vmax=bus[:, 11], ref=ref,
        gen_bus=np.array([idx[int(b)] for b in gen[:, 0]]),
        pmin=gen[:, 9] / base, pmax=gen[:, 8] / base,
        qmin=gen[:, 4] / base, qmax=gen[:, 3] / base,
        cost=cost, Ybus=Ybus, Yf=Yf, Yt=Yt, f=f, t=t, rate2=rate2,
    )


# -------------------------------------------------------------------- model ---
class Model:
    """The problem's functions for one scenario, in real arithmetic, for
    ``torch.func`` (``x`` (n,), ``load`` (2 nb,) = [pd, qd])."""

    def __init__(self, net: Network, dtype=torch.float64):
        self.net = net
        T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
        nb, ng = net.nb, net.ng
        self.G, self.B = T(net.Ybus.real), T(net.Ybus.imag)
        self.Gf, self.Bf = T(net.Yf.real), T(net.Yf.imag)
        self.Gt, self.Bt = T(net.Yt.real), T(net.Yt.imag)
        Cg = np.zeros((nb, ng))
        Cg[net.gen_bus, np.arange(ng)] = 1.0
        self.Cg = T(Cg)
        self.c2, self.c1, self.c0 = (T(net.cost[:, k]) for k in range(3))
        self.rate2 = T(np.concatenate([net.rate2, net.rate2]))  # both ends
        self.base = net.base
        self.dtype = dtype
        lo = np.concatenate([np.full(nb, -np.inf), net.vmin, net.pmin, net.qmin])
        hi = np.concatenate([np.full(nb, np.inf), net.vmax, net.pmax, net.qmax])
        self.x_lo, self.x_hi = lo, hi
        Cf = np.zeros((net.nl, nb))
        Ct = np.zeros((net.nl, nb))
        Cf[np.arange(net.nl), net.f] = 1.0
        Ct[np.arange(net.nl), net.t] = 1.0
        self.Cf, self.Ct = T(Cf), T(Ct)  # end-bus selections as products

    def split(self, x):
        nb, ng = self.net.nb, self.net.ng
        return (x[..., :nb], x[..., nb : 2 * nb], x[..., 2 * nb : 2 * nb + ng],
                x[..., 2 * nb + ng :])

    def cost(self, x):
        mw = self.split(x)[2] * self.base
        return torch.sum(self.c2 * mw * mw + self.c1 * mw + self.c0, dim=-1)

    def _volts(self, x):
        va, vm, _, _ = self.split(x)
        return vm * torch.cos(va), vm * torch.sin(va)

    def equalities(self, x, load):
        """[va_ref; P balance; Q balance], (..., 1 + 2 nb)."""
        nb, ref = self.net.nb, self.net.ref
        va, _, pg, qg = self.split(x)
        e, fi = self._volts(x)
        ir, ii = e @ self.G.T - fi @ self.B.T, e @ self.B.T + fi @ self.G.T
        p = e * ir + fi * ii
        q = fi * ir - e * ii
        return torch.cat([
            va[..., ref : ref + 1],
            pg @ self.Cg.T - load[..., :nb] - p,
            qg @ self.Cg.T - load[..., nb:] - q,
        ], dim=-1)

    def branch_flows(self, x):
        """[|Sf|^2; |St|^2], (..., 2 nl)."""
        e, fi = self._volts(x)
        out = []
        for Gy, By, C in ((self.Gf, self.Bf, self.Cf), (self.Gt, self.Bt, self.Ct)):
            ir, ii = e @ Gy.T - fi @ By.T, e @ By.T + fi @ Gy.T
            ve, vf = e @ C.T, fi @ C.T
            p = ve * ir + vf * ii
            q = vf * ir - ve * ii
            out.append(p * p + q * q)
        return torch.cat(out, dim=-1)

    def rows(self, x, load):
        """Every row of the formulation, in its order."""
        return torch.cat([self.equalities(x, load), self.branch_flows(x)], dim=-1)

    def constraint_hessians(self, x, load, lam, mu):
        """(L, n, n): Hessians of lam . equalities + mu . branch_flows, lane
        by lane, as n forward-over-reverse products on the whole batch (the
        lanes do not interact, so one seed column serves every lane)."""

        def total(z):
            return (torch.sum(lam * self.equalities(z, load))
                    + torch.sum(mu * self.branch_flows(z)))

        return jacobian(torch.func.grad(total), x)

    def cost_grad(self, x):
        """(L, n) gradient of the cost, batched."""
        nb, ng = self.net.nb, self.net.ng
        g = torch.zeros_like(x)
        pg = x[:, 2 * nb : 2 * nb + ng]
        g[:, 2 * nb : 2 * nb + ng] = self.base * (2.0 * self.c2 * self.base * pg + self.c1)
        return g


def jacobian(fn, x):
    """(L, r, n) Jacobians of ``fn`` ((L, n) -> (L, r), lane by lane), as n
    forward products on the whole batch: the lanes do not interact, so one
    seed column serves every lane."""
    n = x.shape[-1]
    seeds = torch.eye(n, dtype=x.dtype)[:, None, :].expand(n, x.shape[0], n)
    cols = vmap(lambda s: torch.func.jvp(fn, (x,), (s,))[1])(seeds)
    return cols.permute(1, 2, 0)


def _solve(K: np.ndarray, rhs: np.ndarray) -> torch.Tensor:
    """Batched solve; a singular system gives NaN on its own lane only (the
    curvature guard then regularizes that lane)."""
    try:
        return torch.as_tensor(np.linalg.solve(K, rhs)[..., 0])
    except np.linalg.LinAlgError:
        out = np.full(rhs.shape[:2], np.nan)
        for i in range(len(K)):
            try:
                out[i] = np.linalg.solve(K[i], rhs[i])[:, 0]
            except np.linalg.LinAlgError:
                pass
        return torch.as_tensor(out)


# ------------------------------------------------------------------- solver ---
@dataclasses.dataclass
class Solution:
    x: np.ndarray  # (L, n)
    obj: np.ndarray  # (L,)
    lam: np.ndarray  # (L, m), program sign convention
    nu_lo: np.ndarray  # (L, n)
    nu_hi: np.ndarray
    solved: np.ndarray  # (L,) bool
    iterations: np.ndarray


def solve(model: Model, loads: np.ndarray, *, tol: float = 1e-9, max_iter: int = 150,
          cost_mult: float = 1e-4) -> Solution:
    """MIPS on every scenario of ``loads`` (L, 2 nb) at once, from the flat
    start (va = 0, vm = 1, generation at the middle of its range); each
    iteration works on the lanes still running.  The cost is scaled by
    ``cost_mult`` inside, as MATPOWER's own OPF driver scales it for MIPS;
    the multipliers come back unscaled.  A lane is solved when MIPS's four
    conditions (feasibility, gradient, complementarity, cost change) all
    fall under ``tol``."""
    net, dt = model.net, model.dtype
    nb, ng, nl, n = net.nb, net.ng, net.nl, net.n
    L = loads.shape[0]
    load_all = torch.as_tensor(loads, dtype=dt)
    neq, nfl = 1 + 2 * nb, 2 * nl
    lo_idx = np.where(np.isfinite(model.x_lo))[0]
    hi_idx = np.where(np.isfinite(model.x_hi))[0]
    nbd = len(lo_idx) + len(hi_idx)
    niq = nfl + nbd
    # the bound rows of h: x[hi] - hi <= 0, then lo - x[lo] <= 0
    Dbd = np.zeros((nbd, n))
    Dbd[np.arange(len(hi_idx)), hi_idx] = 1.0
    Dbd[len(hi_idx) + np.arange(len(lo_idx)), lo_idx] = -1.0
    Dbd = torch.as_tensor(Dbd, dtype=dt)
    bd_rhs = torch.as_tensor(np.concatenate([model.x_hi[hi_idx], -model.x_lo[lo_idx]]), dtype=dt)
    H_cost = torch.zeros(n, n, dtype=dt)
    pgi = torch.arange(2 * nb, 2 * nb + ng)
    H_cost[pgi, pgi] = 2.0 * model.c2 * model.base**2 * cost_mult
    eye = torch.eye(n, dtype=dt)

    def evaluate(x, load):
        f = cost_mult * model.cost(x)
        df = cost_mult * model.cost_grad(x)
        g = model.equalities(x, load)
        h = torch.cat([model.branch_flows(x) - model.rate2, x @ Dbd.T - bd_rhs], dim=1)
        dg = jacobian(lambda z: model.equalities(z, load), x)  # (L, neq, n)
        dh = torch.cat([jacobian(model.branch_flows, x), Dbd.expand(x.shape[0], nbd, n)], dim=1)
        return dict(f=f, df=df, g=g, h=h, dg=dg, dh=dh)

    def conditions(s, f_prev):
        Lx = (s["df"] + torch.einsum("lrn,lr->ln", s["dg"], s["lam"])
              + torch.einsum("lrn,lr->ln", s["dh"], s["mu"]))
        xn = s["x"].abs().amax(1)
        feas = torch.maximum(s["g"].abs().amax(1), s["h"].amax(1).clamp_min(0)) / (
            1 + torch.maximum(xn, s["z"].abs().amax(1)))
        grad = Lx.abs().amax(1) / (1 + torch.maximum(s["lam"].abs().amax(1), s["mu"].abs().amax(1)))
        comp = (s["z"] * s["mu"]).sum(1) / (1 + xn)
        cost = (s["f"] - f_prev).abs() / (1 + f_prev.abs())
        return Lx, (feas < tol) & (grad < tol) & (comp < tol) & (cost < tol)

    def newton(s, load):
        """One MIPS step of the lanes in ``s``, with a curvature guard: a lane
        whose step meets nonpositive curvature of M solves M + delta I again,
        delta growing tenfold from 1e-6."""
        x, z, lam, mu, h, dg, dh = (s[k] for k in ("x", "z", "lam", "mu", "h", "dg", "dh"))
        La = x.shape[0]
        Lxx = H_cost + model.constraint_hessians(x, load, lam, mu[:, :nfl])
        zinv = 1.0 / z
        dh_zinv = dh * zinv[:, :, None]
        M = Lxx + torch.bmm((dh_zinv * mu[:, :, None]).transpose(1, 2), dh)
        N = s["Lx"] + torch.einsum("lrn,lr->ln", dh_zinv, mu * h + s["gamma"][:, None])
        K = torch.zeros(La, n + neq, n + neq, dtype=dt)
        K[:, :n, n:] = dg.transpose(1, 2)
        K[:, n:, :n] = dg
        rhs = torch.cat([-N, -s["g"]], dim=1).numpy()[..., None]
        delta = torch.zeros(La, dtype=dt)
        redo = torch.arange(La)
        sol = torch.zeros(La, n + neq, dtype=dt)
        for _ in range(12):
            K[:, :n, :n] = M + delta[:, None, None] * eye
            sol[redo] = _solve(K[redo].numpy(), rhs[redo.numpy()])
            dx = sol[redo, :n]
            curv = torch.einsum("ln,lnk,lk->l", dx, M[redo], dx)
            bad = ~(curv > 1e-12 * (dx * dx).sum(1))
            if not bool(bad.any()):
                break
            redo = redo[bad]
            delta[redo] = torch.where(delta[redo] == 0, 1e-6, 10.0 * delta[redo])
        dx, dlam = sol[:, :n], sol[:, n:]
        dz = -h - z - torch.einsum("lrn,ln->lr", dh, dx)
        dmu = -mu + zinv * (s["gamma"][:, None] - mu * dz)
        inf = torch.full_like(z, torch.inf)
        ap = torch.clamp_max(0.99995 * torch.where(dz < 0, z / -dz, inf).amin(1), 1.0)[:, None]
        ad = torch.clamp_max(0.99995 * torch.where(dmu < 0, mu / -dmu, inf).amin(1), 1.0)[:, None]
        x, z = x + ap * dx, z + ap * dz
        lam, mu = lam + ad * dlam, mu + ad * dmu
        out = dict(evaluate(x, load), x=x, z=z, lam=lam, mu=mu,
                   gamma=0.1 * (z * mu).sum(1) / niq)
        out["Lx"], conv = conditions(out, s["f"])
        return out, conv

    x0 = np.concatenate([np.zeros(nb), np.ones(nb), 0.5 * (net.pmin + net.pmax),
                         0.5 * (net.qmin + net.qmax)])
    x = torch.as_tensor(np.tile(x0, (L, 1)), dtype=dt)
    st = evaluate(x, load_all)
    z = torch.where(st["h"] < -1.0, -st["h"], torch.ones(L, niq, dtype=dt))
    st.update(x=x, z=z, mu=1.0 / z.clamp_max(1.0), lam=torch.zeros(L, neq, dtype=dt),
              gamma=torch.ones(L, dtype=dt))
    st["Lx"], _ = conditions(st, st["f"])
    done = torch.zeros(L, dtype=torch.bool)
    iters = torch.zeros(L, dtype=torch.int64)
    for _ in range(max_iter):
        idx = torch.nonzero(~done).flatten()
        if idx.numel() == 0:
            break
        sub, conv = newton({k: v[idx] for k, v in st.items()}, load_all[idx])
        for k, v in sub.items():
            st[k][idx] = v
        iters[idx] += 1
        done[idx] = conv
    # program convention: rows' multipliers, then the bound multipliers
    lam, mu = st["lam"] / cost_mult, st["mu"] / cost_mult
    nu_hi = torch.zeros(L, n, dtype=dt)
    nu_lo = torch.zeros(L, n, dtype=dt)
    nu_hi[:, hi_idx] = mu[:, nfl : nfl + len(hi_idx)]
    nu_lo[:, lo_idx] = mu[:, nfl + len(hi_idx) :]
    return Solution(
        x=st["x"].numpy(), obj=(st["f"] / cost_mult).numpy(),
        lam=torch.cat([lam, mu[:, :nfl]], dim=1).numpy(), nu_lo=nu_lo.numpy(),
        nu_hi=nu_hi.numpy(), solved=done.numpy(), iterations=iters.numpy(),
    )


# -------------------------------------------------------------------- judge ---
def judge(model: Model, loads: np.ndarray, answers: dict, ref: Solution) -> dict:
    """The numbers that compare the program's answers with the reference's
    solves of the same scenarios (every array has the lanes first):

    * ``unsolved``: share of the lanes the reference solves whose answer
      does not report a solved status (0, 1 or 6);
    * ``viol``, over the lanes the answer reports solved: the largest
      violation of a row or bound at x (p.u.), by the reference's model;
    * over the lanes the answer reports optimal (0 or 1): ``kkt``, the
      largest |grad f + J' lam + nu_U - nu_L| at the answer's own x and
      multipliers over max(1, |grad f|), by the reference's model; and,
      where the reference solves the lane too, ``obj_gap`` (largest
      |f - f_ref| / |f_ref|), ``x_gap`` (largest |x - x_ref|) and
      ``mult_gap`` (largest |lam - lam_ref| over max(1, |lam_ref|), rows and
      bounds).

    A set with no lane reads 0; ``judged`` counts the lanes of the last set.
    """
    dt = model.dtype
    solved = np.isin(answers["status"], SOLVED)
    ref_ok = ref.solved
    out = dict(
        unsolved=float(np.mean(~solved[ref_ok])) if ref_ok.any() else 0.0,
        lanes=int(len(solved)), judged=int((np.isin(answers["status"], OPTIMAL) & ref_ok).sum()),
        ref_unsolved=int((~ref_ok).sum()),
        viol=0.0, kkt=0.0, obj_gap=0.0, x_gap=0.0, mult_gap=0.0,
    )
    if solved.any():
        x = torch.as_tensor(answers["x"][solved], dtype=dt)
        rows = model.rows(x, torch.as_tensor(loads[solved], dtype=dt)).numpy()
        neq = 1 + 2 * model.net.nb
        xn = x.numpy()
        out["viol"] = float(max(
            np.abs(rows[:, :neq]).max(),
            np.maximum(rows[:, neq:] - model.rate2.numpy(), 0.0).max(),
            np.maximum(np.maximum(model.x_lo - xn, xn - model.x_hi), 0.0).max(),
        ))
    optimal = np.isin(answers["status"], OPTIMAL)
    if optimal.any():
        x = torch.as_tensor(answers["x"][optimal], dtype=dt)
        load = torch.as_tensor(loads[optimal], dtype=dt)
        J = jacobian(lambda z: model.rows(z, load), x)
        df = model.cost_grad(x)
        stat = (df + torch.einsum("lrn,lr->ln", J, torch.as_tensor(answers["mult_g"][optimal], dtype=dt))
                + torch.as_tensor(answers["mult_x_U"][optimal] - answers["mult_x_L"][optimal], dtype=dt))
        out["kkt"] = float((stat.abs().amax(1) / df.abs().amax(1).clamp_min(1.0)).max())
    both = optimal & ref_ok
    if both.any():
        f_ref = ref.obj[both]
        out["obj_gap"] = float((np.abs(answers["obj"][both] - f_ref) / np.abs(f_ref)).max())
        out["x_gap"] = float(np.abs(answers["x"][both] - ref.x[both]).max())
        m_prog = np.concatenate(
            [answers["mult_g"][both], answers["mult_x_U"][both] - answers["mult_x_L"][both]], axis=1)
        m_ref = np.concatenate([ref.lam[both], ref.nu_hi[both] - ref.nu_lo[both]], axis=1)
        out["mult_gap"] = float(
            (np.abs(m_prog - m_ref).max(1) / np.maximum(np.abs(m_ref).max(1), 1.0)).max())
    return out
