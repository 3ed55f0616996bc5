"""A small batch of dense elastic QPs whose regularization ladders escalate
and bisect on some lanes only, and the IPM option sets it is solved under
(``tests/test_torch_qp_trip.py`` on the CPU, ``tests/test_torch_gpu.py`` on
the card); the CPU stand-in for a CUDA-graphed run of stretches, and a
fresh cache for the IPM trip's graphed runs."""

import types

import numpy as np
import torch

from sqpsolver_tpu_torch.ops import qp_ipm, stretches

INF = np.inf
N, M = 10, 14
SHIFT = [0.0, -0.6, 0.0, -3.0, 0.0, -0.2]  # an indefinite direction on lanes 1, 3, 5


def escalating_qps(seed, batch=len(SHIFT), device="cpu"):
    """``batch`` QPs (n=10, m=14): Q, c, A, rl, ru, lb, ub, w, float64."""
    rng = np.random.default_rng(seed)
    Q, c, A, rl, ru, lb, ub = [], [], [], [], [], [], []
    for lane in range(batch):
        L = rng.standard_normal((N, N)) / np.sqrt(N)
        v = rng.standard_normal(N)
        v /= np.linalg.norm(v)
        Q.append(L @ L.T + 0.1 * np.eye(N) + SHIFT[lane] * 4.0 * np.outer(v, v))
        c.append(rng.standard_normal(N))
        Ai = rng.standard_normal((M, N)) / np.sqrt(N)
        mid = Ai @ (rng.standard_normal(N) * 0.1)
        half = np.abs(rng.standard_normal(M)) + 0.1
        kind = rng.integers(0, 4, M)
        r_l = np.where(kind == 1, -INF, mid - half)
        r_u = np.where(kind == 2, INF, mid + half)
        A.append(Ai)
        rl.append(np.where(kind == 3, r_u, r_l))
        ru.append(r_u)
        lb.append(np.full(N, -2.0))
        ub.append(np.full(N, 2.0))
    arrs = [np.stack(a) for a in (Q, c, A, rl, ru, lb, ub)] + [np.full((batch, M), 1e8)]
    return [torch.as_tensor(a, device=device) for a in arrs]


OPTS = {
    "f32_cap": dict(factor_dtype="float32", kkt_backend="pallas", ir_steps=4, invE_floor=3e-7,
                    schur_cap=8, tol=2e-6, max_iter=30),
    "f32": dict(factor_dtype="float32", kkt_backend="pallas", ir_steps=2, tol=2e-6, max_iter=30),
    "f64": dict(tol=1e-8, max_iter=40),
    "plane_cap": dict(factor_dtype="float32", kkt_backend="pallas", plane=True, ir_steps=4,
                      schur_cap=8, tol=2e-6, max_iter=30),
    "polish": dict(factor_dtype="float32", kkt_backend="pallas", ir_steps=2, tol=1e-8,
                   polish_iters=8, max_iter=30, schur_cap=8),
}


class CpuReplay(stretches.Graphed):
    """The graph path's bookkeeping on the CPU: a replay runs the stretch
    function its capture ran, with copy-in writes to the slots."""

    @staticmethod
    def runs_on(device):
        return device.type == "cpu"

    @staticmethod
    def device_memory(device):
        return 1 << 40

    def _capture(self, fn):
        stretches._commit(self.slots, fn(self.slots))

        def replay():
            stretches._commit(self.slots, fn(self.slots))

        return types.SimpleNamespace(replay=replay)


def trip_plans(graphs=True):
    """A fresh cache for the IPM trip's graphed runs, made as
    ``qp_ipm._PLANS`` is, to stand in its place; ``graphs=False`` runs the
    trip as plain calls."""
    plans = stretches.Plans(qp_ipm.solve_qp, limit=qp_ipm._PLANS.limit)
    plans.graphs = graphs
    return plans
