"""Benchmark of the PyTorch/CUDA port ``sqpsolver_tpu_torch``: one run of
one cell of ``BENCHMARK.json``.

    python3 sqpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs on the CUDA card of the machine it is started on.  Set-up (start-up,
kernel build, one warm-up request) is ``setup_s``; then requests run back
to back, one client in a closed loop, until ``--seconds`` have passed (the
request in flight finishes and counts, and where the traffic has a pool,
the pass of the pool in flight).  With ``--trace 1`` whole requests
after the window run under the device profiler and the cell's per-layer
metrics are reported instead of its end-to-end ones.  After the window a
sample of the answers is compared with the plain reference
(``sqpbench/reference``); each compared number and its limit go to
standard error, last, and under ``checks`` at the end of the result line,
the last line of standard output.  Exits non-zero, printing no result,
without a card, with fewer cards than the cell asks for, or when JAX or the
JAX package is loaded in the process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, ".cache")
#: top-level module names the run must not hold: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "sqpsolver_tpu")


def log(msg: str) -> None:
    print(f"sqpbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """Of ``names`` (default: the loaded modules), those whose top-level
    name (the part before the first dot) is one of ``FORBIDDEN``, compared
    whole."""
    return sorted(m for m in (sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache of the run lives at a fixed place inside the checkout
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    from sqpbench.core import harness

    log(f"torch and the harness imported at {time.perf_counter() - T_START:.3f} s")

    try:
        cell = harness.resolve(args.workload, ROOT)
    except (OSError, KeyError) as exc:
        log(f"cannot read the cell: {exc!r}")
        return 2
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {cell.chips}")
        return 3
    torch.cuda.init()
    log(f"CUDA initialised at {time.perf_counter() - T_START:.3f} s")
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package is loaded in the process: {found}")
        return 4
    for name, c in out["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        log(f"check {name}: {c['value']!r} (limit {rel} {c['limit']!r})")
    log(f"correct: {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
