"""Readings of the plain reference computed in float32 and judged in the
program's place, on the CPU: the control of a cell's limits where the
program's own float32 path solves no lane and so reads nothing for
``viol``, ``kkt`` and ``obj_gap``.

Each seed draws the lanes of the cell's requests as a run draws them
(``--requests`` of them, from the mix's pool, or fresh with ``--fresh``).
The reference solves them in float64 at its own settings, and again in
float32, stopped at ``--tol`` (float32 reaches none of the four MIPS
conditions at the float64 run's 1e-9).  The float32 solve's lanes that
stop are reported optimal (status 0), the rest unsolved, and judged
against the float64 solve with the reference's ``judge``.

    python3 sqpbench/reference_control.py --workload case118_b16 --seeds 1,2 \\
        [--fresh] [--requests 2] [--tol 1e-5]

One JSON line per seed: the seed, the lanes, ``correct`` by the cell's
limits, and the judged numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from sqpbench.core import harness  # noqa: E402
from sqpbench.core.traffic import request_loads  # noqa: E402


def control_numbers(ref, net, loads: np.ndarray, tol: float) -> dict:
    """The judge's numbers of the float32 reference's answers on ``loads``."""
    m64 = ref.Model(net)
    sol = ref.solve(ref.Model(net, dtype=torch.float32), loads.astype(np.float32), tol=tol)
    answers = dict(x=sol.x, obj=sol.obj, status=np.where(sol.solved, 0, -1),
                   mult_g=sol.lam, mult_x_L=sol.nu_lo, mult_x_U=sol.nu_hi)
    answers = {k: np.asarray(v, dtype=np.int64 if k == "status" else np.float64)
               for k, v in answers.items()}
    return ref.judge(m64, loads, answers, ref.solve(m64, loads))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args()

    cell = harness.resolve(args.workload)
    traffic = dict(cell.traffic, pool=None) if args.fresh else cell.traffic
    ref = harness.load_module(os.path.join(BENCH_DIR, "reference", f"{cell.config['reference']}.py"))
    net = ref.read_case(cell.path(cell.config["case_file"]))
    limits = cell.config["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        loads = np.concatenate([request_loads(net, traffic, seed, i) for i in range(args.requests)])
        numbers = control_numbers(ref, net, loads, args.tol)
        correct = numbers["judged"] > 0 and all(numbers[k] <= v for k, v in limits.items())
        print(json.dumps(dict(workload=args.workload, seed=seed, fresh=args.fresh, tol=args.tol,
                              lanes=len(loads), correct=correct, numbers=numbers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
