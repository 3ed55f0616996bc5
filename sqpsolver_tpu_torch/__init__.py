"""sqpsolver_tpu_torch: the trust-region SQP solver ported to PyTorch + CUDA.

The port of the JAX package that sits beside it in this repository (the
reference it is tested against), written batch-first for an NVIDIA Hopper
GPU.  It imports torch and numpy only.  The factorization on the KKT path
is a hand-written CUDA kernel (``csrc/chol_tile.cu``, built with ``nvcc`` at
first use); on the CPU the same algorithm runs in plain torch ops.

Tensors go to the CUDA card unless the caller names another device:
``batch_data``, ``NLP.data``, ``nlp_data_to_torch`` and ``theta_to_torch``
take ``device=None`` (the card) and raise where there is none; pass
``device="cpu"`` to run on the CPU.  The solver runs where its data lies.

Quick start (one NLP, on the GPU; ``device="cpu"`` runs it on the CPU)::

    import sqpsolver_tpu_torch as sqp
    from sqpsolver_tpu_torch.models.hs import hs_problem
    res = sqp.optimize(hs_problem("hs071").nlp, sqp.Parameters(max_iter=200))
    print(res.x, res.status_name)

The compute dtype is ``Parameters.dtype`` (float64 by default); there is no
switch to turn float64 on, as the JAX package's ``enable_x64`` does.

``Parameters(kkt_structured=True)`` on an NLP with a ``structure``
(``acopf_polar`` sets one; ``structure.detect_structure`` finds one) runs
the QPs through the block-structured KKT backend (``ops/kkt_bbd.py``) with
coloring-compressed derivatives; ``models/stochastic.py`` couples load
scenarios into one such NLP.

Batched ACOPF on case30, on the GPU::

    import torch
    from sqpsolver_tpu_torch import Parameters, batch_data, make_batch_solver
    from sqpsolver_tpu_torch.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu_torch.models.matpower import load_case

    case = load_case("case30")
    nlp = acopf_polar(case)
    data = batch_data(nlp, 32, theta=load_scenarios(case, 32, seed=7, spread=0.03))
    params = Parameters(kkt_precision="mixed_ir", hessian_shift="ladder",
                        kkt_backend="pallas", qp_rescue=False,
                        init_projection="off", OutputFlag=0)
    res = make_batch_solver(nlp, params)(data)

Several devices: ``make_sharded_solver(nlp, params, instance_mesh())`` cuts
the lanes over the GPUs and runs the shards in turn in this process;
``parallel.multihost`` runs one process per GPU on ``torch.distributed``
(``torchrun --nproc_per_node=N``).  ``utils.flops`` and ``utils.profiling``
hold the analytic FLOP counts, the card's peak rates and the profiler
helpers.
"""

from __future__ import annotations

import time as _time

import torch as _torch

from .algorithms.sqp_tr import SqpResult, SqpState
from .convert import (
    nlp_data_to_torch,
    result_to_numpy,
    sqp_state_to_numpy,
    sqp_state_to_torch,
    theta_to_torch,
)
from .nlp import NLP, NLPData, build_nlp, initial_point
from .parallel.batch import (
    batch_data,
    make_batch_solver,
    make_chunked_batch_solver,
    summarize_batch,
)
from .parallel.sharding import (
    instance_mesh,
    make_block_sharded_solver,
    make_sharded_solver,
    shard_data,
    solve_sharded,
)
from .nlp import resolve_device
from .parameters import Parameters, get_parameter, set_parameter
from .results import Results, from_raw
from .status import STATUS_NAME, Status, is_success, status_name

__version__ = "0.1.0"

__all__ = [
    "NLP",
    "NLPData",
    "Parameters",
    "Results",
    "STATUS_NAME",
    "SqpResult",
    "SqpState",
    "Status",
    "batch_data",
    "build_nlp",
    "from_raw",
    "get_parameter",
    "initial_point",
    "instance_mesh",
    "is_success",
    "make_batch_solver",
    "make_block_sharded_solver",
    "make_chunked_batch_solver",
    "make_sharded_solver",
    "make_solver",
    "nlp_data_to_torch",
    "optimize",
    "result_to_numpy",
    "set_parameter",
    "shard_data",
    "solve_sharded",
    "sqp_state_to_numpy",
    "sqp_state_to_torch",
    "status_name",
    "summarize_batch",
    "theta_to_torch",
]


def make_solver(nlp: NLP, params: Parameters = Parameters(), **kw):
    """Build the batched solve function (batched :class:`NLPData` ->
    batched :class:`SqpResult`) of ``params.algorithm``: "SQP-TR"
    (``algorithms.sqp_tr.make_solver``) or "SQP-LS"
    (``algorithms.sqp_ls.make_ls_solver``); ``kw`` goes to that constructor
    (``verbose``)."""
    if params.algorithm == "SQP-TR":
        from .algorithms.sqp_tr import make_solver as build
    elif params.algorithm == "SQP-LS":
        from .algorithms.sqp_ls import make_ls_solver as build
    else:
        # reference: unknown algorithm -> status -12 Invalid_Option
        # (src/model.jl:86-90); fail loudly at build time instead
        raise ValueError(
            f"unknown algorithm {params.algorithm!r} (Invalid_Option); "
            "expected 'SQP-TR' or 'SQP-LS'"
        )
    return build(nlp, params, **kw)


def optimize(nlp: NLP, params: Parameters = Parameters(), *, device=None, **kw) -> Results:
    """Solve one NLP end to end and return host-side :class:`Results`.

    The NLP is solved as a batch of one lane on ``device`` (``None``: the
    CUDA card, and a ``RuntimeError`` naming ``device="cpu"`` where there is
    none); ``solve_time`` runs until the card has finished.  ``kw`` goes to
    :func:`make_solver` (``verbose``).
    """
    device = resolve_device(device)
    solver = make_solver(nlp, params, **kw)
    dtype = _torch.float64 if params.dtype == "float64" else _torch.float32
    data = batch_data(nlp, 1, dtype=dtype, device=device)
    t0 = _time.time()
    raw = solver(data)
    if device.type == "cuda":
        _torch.cuda.synchronize(device)
    return from_raw(raw, _time.time() - t0)
