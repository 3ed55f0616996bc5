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

Quick start (batched ACOPF on case30, on the GPU)::

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
"""

from __future__ import annotations

from .algorithms.sqp_tr import SqpResult, SqpState, make_solver
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
from .parameters import Parameters, get_parameter, set_parameter
from .status import STATUS_NAME, Status, is_success, status_name

__version__ = "0.1.0"

__all__ = [
    "NLP",
    "NLPData",
    "Parameters",
    "STATUS_NAME",
    "SqpResult",
    "SqpState",
    "Status",
    "batch_data",
    "build_nlp",
    "get_parameter",
    "initial_point",
    "is_success",
    "make_batch_solver",
    "make_chunked_batch_solver",
    "make_solver",
    "nlp_data_to_torch",
    "result_to_numpy",
    "set_parameter",
    "sqp_state_to_numpy",
    "sqp_state_to_torch",
    "status_name",
    "summarize_batch",
    "theta_to_torch",
]
