"""Profiling and timing helpers (torch port of the JAX package's
``utils/profiling.py``).

* :func:`trace` -- a context manager around ``torch.profiler`` that writes a
  Chrome / TensorBoard trace of the enclosed block (kernel timeline, host
  launches) into a directory;
* :func:`solve_timing` -- first call against steady state of a solve
  function, each call timed until the card has finished;
* per-iteration counters (QP interior-point iterations, accept/reject/SOC/FR
  counts) ride in the solver state and come back in
  :class:`sqpsolver_tpu_torch.results.Results`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from ..nlp import resolve_device


@contextlib.contextmanager
def trace(logdir: str, *, device=None):
    """Profile the enclosed block with ``torch.profiler`` and write its trace
    (``<worker>.<time>.pt.trace.json``) into ``logdir``.  Records CPU and CUDA
    activity; ``device="cpu"`` records the CPU only.  ``device=None`` is the
    card, and raises where there is none.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _synchronize(out) -> None:
    """Wait for the card that holds ``out``'s first tensor (a tensor, or a
    tuple, NamedTuple, dict or dataclass of them)."""
    stack = [out]
    while stack:
        node = stack.pop()
        if torch.is_tensor(node):
            if node.device.type == "cuda":
                torch.cuda.synchronize(node.device)
            return
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, (tuple, list)):
            stack.extend(reversed(node))
        elif hasattr(node, "__dataclass_fields__"):
            stack.extend(reversed([getattr(node, f) for f in node.__dataclass_fields__]))


def solve_timing(fn: Callable, *args, repeats: int = 3) -> dict:
    """(first call, steady-state call) seconds of ``fn(*args)``, each call
    timed until the device of its output has finished."""
    t0 = time.perf_counter()
    out = fn(*args)
    _synchronize(out)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
        _synchronize(out)
    steady = (time.perf_counter() - t0) / repeats
    return {
        "first_call_s": first,
        "steady_state_s": steady,
        "compile_overhead_s": max(first - steady, 0.0),
    }
