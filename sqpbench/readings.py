"""Readings of the compared numbers over many seeds in one process: the
program as the cell runs it, its control (``--control``: the program's
float32 path, ``dtype="float32"``), or the program with a planted fault
(``--fault``, see ``core/faults.py``), at the cell's own size with a window
of ``--seconds``; ``--fresh`` draws every request from the seed and its
index instead of the mix's pool.  Set-up is paid once for CUDA and the
kernel build; each seed builds its entry and warms it up again.

    python3 sqpbench/readings.py --workload case30_b32 --seeds 1,2,3 --seconds 10 \\
        [--control] [--fresh] [--fault half,altered] --out out/readings.jsonl

One JSON line per seed: the seed, ``correct``, the compared numbers and
the end-to-end metrics.
"""

from __future__ import annotations

import argparse
import ast
import itertools
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from sqpbench.core import faults  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--fault", help="a planted fault, or several joined by commas")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch

    from sqpbench.core import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    overrides = {"parameters": {"dtype": "float32"} if args.control else {},
                 "traffic": {"pool": None} if args.fresh else {}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        for fault, seed in itertools.product(
                args.fault.split(",") if args.fault else [None],
                (int(s) for s in args.seeds.split(","))):
            numbers = {}
            wrap = (lambda entry, fault=fault: faults.Fault(entry, fault)) if fault else None

            def log(msg, seed=seed, numbers=numbers):
                print(f"readings {seed}: {msg}", file=sys.stderr, flush=True)
                if msg.startswith("reference: "):  # every number, compared or logged
                    text = msg.split("; ", 1)[1]
                    try:
                        numbers.update(ast.literal_eval(text))
                    except (ValueError, SyntaxError):  # a nan or inf reads as a name
                        numbers["text"] = text

            out = harness.run_cell(
                args.workload, seed, args.seconds, False, device="cuda:0", overrides=overrides,
                wrap_entry=wrap, log=log)
            rec = dict(workload=args.workload, seed=seed, control=args.control,
                       fresh=args.fresh, fault=fault,
                       correct=out["correct"], failed=out["failed"], attempted=out["attempted"],
                       checks={k: c["value"] for k, c in out["checks"].items()}, numbers=numbers,
                       metrics={k: m["value"] for k, m in out["metrics"].items()})
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
