"""Pegase-scale end-to-end ACOPF solve in the PyTorch port, on one CUDA card.

The port's counterpart of ``scripts/pegase_solve.py``: ``k`` interconnected
copies of the real IEEE case118 (``models/power.replicate_case``) through
the structured (BBD) path with that script's parameters (float64 ``direct``
factors, ``ladder`` shift, SOC, ``qp_rescue`` on, no initial projection;
``anchor_replicated.json``'s ``pegase_params``), one lane through the
chunked batch solver as that script drives the chip:

    case118x12 -> 1,416 buses, n=4,128   (pegase-1354 scale)
    case118x24 -> 2,832 buses, n=8,256   (pegase-2869 scale)

Usage, from the repository root on a machine with a CUDA card::

    python scripts/torch_pegase_solve.py [k] [maxit] [--out PATH]
    python scripts/torch_pegase_solve.py 12 --both [--out PATH]

Prints the partition and its host build time, one line per SQP round with
the elapsed time, then status, iterations, objective, ``inf_pr``, wall, peak
device memory and host RSS, the IPM trips, host syncs and the objective
over ``k`` times the single case's optimum (replicating the single optimum
is feasible, so the coupled optimum sits at or just below it); ``--out``
also writes these as JSON.  ``--both`` runs ``chip_smoke.py`` phase 19's
whole solves instead (``chip_smoke.pegase_full``: the kernel path under the
structured bench configuration, then these parameters at
``chip_smoke.PEGASE_MAX_ITER``) and exits 1 if a gate fails: each solved,
in the band, the two within 1e-6.  Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("k", nargs="?", type=int, default=12, help="copies of case118 (default 12)")
    ap.add_argument("maxit", nargs="?", type=int, default=40, help="max_iter (default 40)")
    ap.add_argument("--both", action="store_true",
                    help="the kernel path and these parameters in full, with phase 19's gates")
    ap.add_argument("--out", default=None, help="write the result as JSON to this path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_pegase_solve: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sqpsolver_tpu_torch.models.matpower import VENDORED_OPTIMA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    anchor = cs._anchor(cs.ANCHOR_REPLICATED)
    params = dict(anchor["pegase_params"], max_iter=args.maxit)
    case, nlp = cs.replicated_nlp("case118", args.k)
    print(f"backend=cuda card={card} case={case.name} buses={case.nb} n={nlp.n} m={nlp.m}",
          flush=True)
    part, _ = cs.block_partition(nlp)
    print(f"partition: P={part['P']} nd={part['nd']} ns={part['ns']} cap_p={part['cap_p']} "
          f"nS={part['nS']} nJ={part['nJ']} nH={part['nH']}, built in {part['seconds']:.3f} s "
          f"on the host", flush=True)
    t0 = time.perf_counter()

    def progress(msg):
        print(f"[{time.perf_counter() - t0:9.1f}s] {msg}", flush=True)

    def out(msg):
        print(msg, flush=True)

    single = VENDORED_OPTIMA["case118"]
    if args.both:
        runs = cs.pegase_full(torch, nlp, args.k, anchor, out=out, progress=progress)
        failures = runs[2]
        runs = dict(a=runs[0], b=runs[1])
    else:
        runs = dict(b=cs.pegase_lane(torch, nlp, params, out=out, tag=case.name,
                                     progress=progress))
        failures = []
    for name, r in runs.items():
        ratio = r["obj"] / (args.k * single)
        print(f"{name}: status={r['status']} iters={r['iterations']} obj={r['obj']:.2f} "
              f"inf_pr={r['prim']:.2e} wall={r['wall']:.1f}s peak_device={r['peak_gb']:.3f}GiB "
              f"peak_rss={r['rss_gb']:.3f}GiB", flush=True)
        print(f"{name}: sanity band: k*f*_single = {args.k * single:.2f} (obj/band = "
              f"{ratio:.6f})", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        rec = dict(card=card, case=case.name, k=args.k, n=nlp.n, m=nlp.m, partition=part,
                   failures=failures,
                   runs={name: dict({key: val for key, val in r.items() if key != "x"},
                                    band_ratio=r["obj"] / (args.k * single))
                         for name, r in runs.items()})
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    for f in failures:
        print(f"FAIL {f}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
