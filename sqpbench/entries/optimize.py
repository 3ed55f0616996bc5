"""Entry of one OPF solved on demand: each request builds the network with
its own loads and the model of it that the configuration names, and calls
``optimize``, which builds its solver and solves the one scenario."""

from __future__ import annotations

import dataclasses

import numpy as np


class Optimize:
    def __init__(self, case_path: str, formulation: str, parameters: dict, lanes: int, device):
        import sqpsolver_tpu_torch as sqp
        from sqpsolver_tpu_torch.models import acopf
        from sqpsolver_tpu_torch.models.matpower import parse_matpower

        if lanes != 1:
            raise ValueError("optimize solves one scenario a request")
        self._sqp = sqp
        self._formulation = getattr(acopf, formulation)
        self.params = sqp.Parameters(**parameters)
        self.case = parse_matpower(case_path)
        self.device = device

    def model(self, case):
        """The model of ``case`` that ``optimize`` is handed."""
        return self._formulation(case, scenario_batchable=False)

    def request(self, loads) -> dict:
        """Solve the one scenario ``loads`` (1, 2 nb); the answer is on the
        host, as ``optimize`` returns it."""
        nb = self.case.nb
        case = dataclasses.replace(self.case, bus_pd=loads[0, :nb], bus_qd=loads[0, nb:])
        nlp = self.model(case)
        res = self._sqp.optimize(nlp, self.params, device=self.device)

        def lane(a):
            return np.asarray(a)[None]

        return dict(
            x=lane(res.x), obj=lane(res.obj_val), status=lane(int(res.status)),
            mult_g=lane(res.mult_g), mult_x_L=lane(res.mult_x_L), mult_x_U=lane(res.mult_x_U),
            iterations=lane(res.iterations), qp_iterations=lane(res.qp_iters_total),
        )


def build(**kw):
    return Optimize(**kw)
