"""Write the per-lane JAX reference that ``chip_smoke.py`` holds the port to.

Runs the JAX package on the CPU with the PyTorch port's slice configuration
(real MATPOWER case30, 32 load scenarios, dense SQP-TR with ``mixed_ir``
factorizations, the ``ladder`` Hessian shift, rescue and initial projection
off) and writes each lane's status, objective, SQP iterations and IPM trips
to ``sqpsolver_tpu_torch/data/anchor_case30_b32.json``.  The file also holds
the configuration itself, so the smoke run and this script cannot drift
apart.

Usage::

    JAX_PLATFORMS=cpu python scripts/torch_anchor.py [--out PATH]

The factorization backend is the slice's own, ``kkt_backend="pallas"``: on
the CPU the JAX Cholesky kernel runs in interpret mode, the closest reference
to the port's hand-written kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "sqpsolver_tpu_torch", "data", "anchor_case30_b32.json")

#: the slice: bench.py's case30 b32 configuration plus the kernel backend
SLICE = dict(
    case="case30",
    batch=32,
    seed=7,
    spread=0.03,
    params=dict(
        max_iter=40,
        OutputFlag=0,
        tol_infeas=1.0e-6,
        tol_residual=1.0e-4,
        qp_max_iter=30,
        dtype="float64",
        kkt_precision="mixed_ir",
        hessian_shift="ladder",
        kkt_ir_steps=2,
        qp_rescue=False,
        schur_cap=-1,
        init_projection="off",
        kkt_backend="pallas",
    ),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from sqpsolver_tpu.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.parallel.batch import (
        batch_data,
        make_batch_solver,
        summarize_batch,
    )
    from sqpsolver_tpu.parameters import Parameters

    case = load_case(SLICE["case"])
    nlp = acopf_polar(case)
    params = Parameters(**SLICE["params"])
    theta = load_scenarios(
        case, SLICE["batch"], seed=SLICE["seed"], spread=SLICE["spread"]
    )
    data = batch_data(nlp, SLICE["batch"], theta=theta, dtype=jnp.float64)
    t0 = time.time()
    out = make_batch_solver(nlp, params)(data)
    jax.block_until_ready(out.x)
    seconds = time.time() - t0
    summ = summarize_batch(out)
    record = dict(
        SLICE,
        reference=dict(
            package="JAX reference package",
            platform=jax.devices()[0].platform,
            jax_version=jax.__version__,
            kkt_backend=params.kkt_backend,
            seconds_with_compile=round(seconds, 1),
        ),
        lanes=dict(
            status=np.asarray(out.status).astype(int).tolist(),
            obj=[float(v) for v in np.asarray(out.obj_val)],
            iterations=np.asarray(out.iterations).astype(int).tolist(),
            qp_trips=np.asarray(out.qp_iters_total).astype(int).tolist(),
        ),
        totals=dict(
            iterations=int(np.asarray(out.iterations).sum()),
            qp_trips=summ["qp_trips"],
            n_reject=summ["n_reject"],
            n_success=summ["n_success"],
            obj_mean=summ["obj_mean"],
            prim_infeas_max=summ["prim_infeas_max"],
        ),
    )
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(json.dumps(record["totals"]), f"{seconds:.1f}s")


if __name__ == "__main__":
    main()
