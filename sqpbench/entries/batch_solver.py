"""Entry of a batch of scenarios: ``make_batch_solver`` built once in
set-up, each request tiles the network over its scenarios with
``batch_data`` and solves them in one call."""

from __future__ import annotations

import torch


class BatchSolver:
    def __init__(self, case_path: str, formulation: str, parameters: dict, lanes: int, device):
        import sqpsolver_tpu_torch as sqp
        from sqpsolver_tpu_torch.models import acopf
        from sqpsolver_tpu_torch.models.matpower import parse_matpower

        self._sqp = sqp
        self.params = sqp.Parameters(**parameters)
        self.dtype = torch.float64 if self.params.dtype == "float64" else torch.float32
        case = parse_matpower(case_path)
        self.nb = case.nb
        self.nlp = getattr(acopf, formulation)(case)
        self.solver = sqp.make_batch_solver(self.nlp, self.params)
        self.lanes = lanes
        self.device = device

    def request(self, loads) -> dict:
        """Solve the scenarios ``loads`` (lanes, 2 nb); the answer's tensors
        stay on the device."""
        theta = {"pd": loads[:, : self.nb], "qd": loads[:, self.nb :]}
        data = self._sqp.batch_data(self.nlp, self.lanes, theta=theta, dtype=self.dtype,
                                    device=self.device)
        out = self.solver(data)
        return dict(
            x=out.x, obj=out.obj_val, status=out.status, mult_g=out.mult_g,
            mult_x_L=out.mult_x_L, mult_x_U=out.mult_x_U, iterations=out.iterations,
            qp_iterations=out.qp_iters_total,
        )


def build(**kw):
    return BatchSolver(**kw)
