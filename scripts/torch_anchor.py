"""Write the per-lane JAX references that ``chip_smoke.py`` holds the port to.

Runs the JAX package on the CPU with one of the PyTorch port's two path
configurations and writes each lane's status, objective, SQP iterations and
IPM trips to ``sqpsolver_tpu_torch/data/anchor_<case>_b<batch>.json``.  The
file also holds the configuration itself, so the smoke run and this script
cannot drift apart.

* ``--case case30 --batch 32`` (the default): real MATPOWER case30, dense
  SQP-TR with ``mixed_ir`` factorizations, the ``ladder`` Hessian shift,
  rescue and initial projection off, one monolithic batched solve.
* ``--case case118 --batch 16``: real IEEE case118 (n=344, m=609) with the
  same parameters through ``make_chunked_batch_solver(sub_batch=128,
  rescue_fallback=True)``: a float32-factor first pass, then a rescue-enabled
  re-solve (float64 IPM phase 2) of the lanes that ended in
  ``Error_In_Step_Computation``.  The first pass is also run on its own, so
  the file can say which lanes took the fallback.

Usage::

    JAX_PLATFORMS=cpu python scripts/torch_anchor.py [--case C] [--batch B]
        [--backend pallas|xla] [--max-iter N] [--cache-dir DIR] [--out PATH]

The reference's factorization backend defaults to the path's own,
``kkt_backend="pallas"``: on the CPU the JAX Cholesky kernel runs in
interpret mode, the closest reference to the port's hand-written kernel.
``--backend xla`` runs the reference through ``jnp.linalg.cholesky`` instead
(the file's ``params`` keep the path's own backend, ``reference`` names the
one that ran).  The rescue path needs it: the JAX package's blocked route
casts every matrix to float32, float64 phase-2 factors included, while its
xla route factors them in float64 as the port does.  ``--cache-dir`` names a
JAX persistent compilation cache, which lets the two case118 solves share
their compiled programs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "sqpsolver_tpu_torch", "data")

#: bench.py's dense configuration plus the kernel backend
PARAMS = dict(
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
)

#: how bench.py drives each case: case118 goes through the chunked solver
CHUNKED = {
    "case30": None,
    "case118": dict(sub_batch=128, rescue_fallback=True),
}


XLA_NOTE = (
    "reference run with kkt_backend='xla': the JAX package's blocked "
    "(pallas) route casts every matrix to float32, so under it the IPM's "
    "phase 2 is not a float64 phase; the xla route factors phase 2 in true "
    "float64, which is what the port does under either backend"
)


def lanes_of(out) -> dict:
    return dict(
        status=np.asarray(out.status).astype(int).tolist(),
        obj=[float(v) for v in np.asarray(out.obj_val)],
        iterations=np.asarray(out.iterations).astype(int).tolist(),
        qp_trips=np.asarray(out.qp_iters_total).astype(int).tolist(),
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="case30", choices=sorted(CHUNKED))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    ap.add_argument("--max-iter", type=int, default=PARAMS["max_iter"])
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_path = args.out or os.path.join(
        DATA, f"anchor_{args.case}_b{args.batch}.json"
    )

    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    if args.cache_dir:
        jax.config.update("jax_compilation_cache_dir", args.cache_dir)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    import jax.numpy as jnp

    from sqpsolver_tpu.models.acopf import acopf_polar, load_scenarios
    from sqpsolver_tpu.models.matpower import load_case
    from sqpsolver_tpu.parallel.batch import (
        batch_data,
        make_batch_solver,
        make_chunked_batch_solver,
        summarize_batch,
    )
    from sqpsolver_tpu.parameters import Parameters
    from sqpsolver_tpu.status import Status

    config = dict(
        case=args.case,
        batch=args.batch,
        seed=7,
        spread=0.03,
        params=dict(PARAMS, max_iter=args.max_iter),
    )
    chunked = CHUNKED[args.case]
    if chunked:
        config["chunked"] = chunked
    case = load_case(config["case"])
    nlp = acopf_polar(case)
    # the file's ``params`` are the path's own (the kernel backend); the
    # reference may run the library backend instead, and says so
    params = Parameters(**dict(config["params"], kkt_backend=args.backend))
    theta = load_scenarios(
        case, config["batch"], seed=config["seed"], spread=config["spread"]
    )
    data = batch_data(nlp, config["batch"], theta=theta, dtype=jnp.float64)

    def log(msg: str) -> None:
        print(f"[{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    t0 = time.time()
    extra = {}
    if chunked:
        first = make_chunked_batch_solver(
            nlp, params, sub_batch=chunked["sub_batch"], log=log
        )(data)
        jax.block_until_ready(first.x)
        failed = np.asarray(first.status) == int(
            Status.ERROR_IN_STEP_COMPUTATION
        )
        extra["first_pass"] = dict(
            lanes_of(first),
            seconds_with_compile=round(time.time() - t0, 1),
        )
        extra["fallback_lanes"] = np.where(failed)[0].astype(int).tolist()
        log(f"first pass done; fallback lanes {extra['fallback_lanes']}")
        out = make_chunked_batch_solver(nlp, params, log=log, **chunked)(data)
    else:
        out = make_batch_solver(nlp, params)(data)
    jax.block_until_ready(out.x)
    seconds = time.time() - t0
    summ = summarize_batch(out)
    record = dict(
        config,
        reference=dict(
            package="JAX reference package",
            platform=jax.devices()[0].platform,
            jax_version=jax.__version__,
            kkt_backend=params.kkt_backend,
            seconds_with_compile=round(seconds, 1),
            **({"note": XLA_NOTE} if args.backend == "xla" else {}),
        ),
        lanes=lanes_of(out),
        **extra,
        totals=dict(
            iterations=int(np.asarray(out.iterations).sum()),
            qp_trips=summ["qp_trips"],
            n_reject=summ["n_reject"],
            n_success=summ["n_success"],
            obj_mean=summ["obj_mean"],
            prim_infeas_max=summ["prim_infeas_max"],
        ),
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(json.dumps(record["totals"]), f"{seconds:.1f}s")


if __name__ == "__main__":
    main()
