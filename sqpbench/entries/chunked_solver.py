"""Entry of a batch of scenarios through the chunked solver:
``make_chunked_batch_solver`` built once in set-up, with its keywords
``sub_batch`` and ``rescue_fallback`` taken out of the parameters; each
request tiles the network over its scenarios with ``batch_data`` and
solves them in one call, as ``batch_solver.py`` does.

The answer holds ``batch_solver.py``'s keys and what the program's
process-wide counters of the chunked solver and of the IPM's CUDA graphs
(:func:`counters`) moved by during the request's call.  These are host
numbers, read without a sync; each is one number of the request, repeated
on every lane so that the answer stays lanes first, as the harness and its
planted faults take it.
"""

from __future__ import annotations

import os

import numpy as np

from sqpbench.core.harness import BENCH_DIR, load_module

#: the chunked solver's keyword arguments among the configuration's parameters
CHUNKED = ("sub_batch", "rescue_fallback")

_batch = load_module(os.path.join(BENCH_DIR, "entries", "batch_solver.py"))


def counters() -> dict:
    """The program's counters of the chunked solver and of the IPM's CUDA
    graphs, by answer key; a program without the chunked solver's counters
    leaves them out."""
    from sqpsolver_tpu_torch.ops.qp_ipm import solve_qp
    from sqpsolver_tpu_torch.parallel.batch import make_chunked_batch_solver as chunked

    out = dict(graph_captures=solve_qp.graph_captures, graph_replays=solve_qp.graph_replays)
    if hasattr(chunked, "pass_seconds"):
        out.update(
            chunked_rounds=chunked.rounds, first_pass_s=chunked.pass_seconds["first"],
            fallback_s=chunked.pass_seconds["fallback"], fallback_lanes=chunked.fallback_lanes,
            fallback_rounds=chunked.fallback_rounds,
        )
    return out


class ChunkedSolver(_batch.BatchSolver):
    def __init__(self, case_path: str, formulation: str, parameters: dict, lanes: int, device):
        params = dict(parameters)
        keywords = {k: params.pop(k) for k in CHUNKED}
        super().__init__(case_path, formulation, params, lanes, device)
        # the chunked solver in place of the plain one built above
        self.solver = self._sqp.make_chunked_batch_solver(self.nlp, self.params, **keywords)

    def request(self, loads) -> dict:
        before = counters()
        answer = super().request(loads)
        after = counters()
        for key, value in after.items():
            answer[key] = np.full(self.lanes, value - before[key])
        return answer


def build(**kw):
    return ChunkedSolver(**kw)
