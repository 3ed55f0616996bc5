"""Checkpoint / resume of long (batched) solves (torch port of the JAX
package's ``utils/checkpoint.py``).

The SQP-TR solve function carries its three stages (``init_state``,
``run_until``, ``finalize``), so a long solve advances in chunks of
iterations and the state's tensors are saved between chunks with
``torch.save``; after a preemption the solve resumes from the latest save.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from ..algorithms.sqp_tr import SqpResult, SqpState, make_solver
from ..nlp import NLP, NLPData
from ..parameters import Parameters
from ..status import Status

_FILE = "sqp_state.pt"


def _save(state: SqpState, path: str) -> None:
    """Write the state's tensors to ``path`` through a temporary file and an
    atomic rename, so a preemption mid-write leaves the last save intact."""
    tmp = path + ".tmp"
    torch.save({f.name: getattr(state, f.name) for f in dataclasses.fields(SqpState)}, tmp)
    os.replace(tmp, path)


def _load(path: str, device) -> SqpState:
    return SqpState(**torch.load(path, map_location=device, weights_only=True))


def solve_with_checkpoints(
    nlp: NLP,
    params: Parameters,
    data: NLPData,
    *,
    chunk_iters: int = 50,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
) -> SqpResult:
    """Solve batched ``data`` (a leading lane axis on every tensor) with
    SQP-TR in chunks of ``chunk_iters`` iterations.

    With ``checkpoint_dir`` set, the state is saved after every chunk and, if
    ``resume`` and a save exists, the solve continues from it (on the data's
    device) instead of starting over.

    ``params.time_limit`` is honored at chunk boundaries: once the wall clock
    exceeds it the solve stops and unfinished lanes report
    ``Maximum_CpuTime_Exceeded`` (-4).  (The reference declares this
    parameter and never implements it, ``src/parameters.jl:21``.)
    """
    t_start = time.time()
    solver = make_solver(nlp, params, verbose=False)
    path = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(os.path.abspath(checkpoint_dir), _FILE)
    if path is not None and resume and os.path.exists(path):
        st = _load(path, data.x0.device)
    else:
        st = solver.init_state(data)

    max_iter = params.max_iter
    timed_out = False
    while True:
        # one host transfer per chunk: every lane's iteration and done flag
        it, done = torch.stack([st.iter, st.done.to(st.iter.dtype)]).tolist()
        if all(done) or max(it) > max_iter:
            break
        if time.time() - t_start > params.time_limit:
            timed_out = True
            break
        st = solver.run_until(st, data, min(max(it) + chunk_iters - 1, max_iter))
        if path is not None:
            _save(st, path)

    result = solver.finalize(st, data)
    if timed_out:
        result = result._replace(status=torch.where(
            st.done, result.status, int(Status.MAXIMUM_CPUTIME_EXCEEDED)
        ).to(torch.int32))
    return result
