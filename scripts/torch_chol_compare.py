"""Time the port's Cholesky kernel against other sources of the same kernel,
on one NVIDIA GPU, within one process.

Usage, from the repository root, on a machine with a CUDA card and ``nvcc``::

    git show <commit>:sqpsolver_tpu_torch/csrc/chol_tile.cu > /tmp/old.cu
    python3 scripts/torch_chol_compare.py --other old=/tmp/old.cu [--other ...] \
        [--out summary.json]

Each ``--other NAME=PATH`` is a CUDA source with the C entry point
``sqp_chol_tile_f32(in, out, batch, n, stream)``; it is built with the
package's own ``nvcc`` flags into a temporary directory.  ``current`` is
``sqpsolver_tpu_torch/csrc/chol_tile.cu``, built and launched through the
package's wrapper.  At (32,72,72), (32,96,96) and (256,128,128) every version
is held against ``chol_tile_plain`` and timed with CUDA events in turns
(others, current, current, others), two ways: ``queued`` (20 launches enqueued
behind a large matrix product, device time only) and ``single`` (one call per
event pair, host enqueue included).  ``torch.linalg.cholesky_ex`` is timed
beside them as the library yardstick.  Prints one line per measurement and a
JSON summary with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sqpsolver_tpu_torch.ops import _build, chol_blocked  # noqa: E402


def build_other(name: str, src: str, out_dir: str):
    """Compile ``src`` and return ``fn(M) -> L`` launching its kernel."""
    path = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", path, src],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"build {name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(path)
    lib.sqp_chol_tile_f32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.sqp_chol_tile_f32.restype = ctypes.c_int

    def fn(M):
        out = torch.empty_like(M)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sqp_chol_tile_f32(M.data_ptr(), out.data_ptr(), M.shape[0], M.shape[1], stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
        return out

    fn.__name__ = name
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--out", metavar="PATH", help="write the summary as JSON to PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_chol_compare: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    info = _build.build("chol_tile")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build current: {line.strip()}", flush=True)
    versions = {}
    with tempfile.TemporaryDirectory() as tmp:
        for spec in args.other:
            name, _, src = spec.partition("=")
            versions[name] = build_other(name, src, tmp)
        versions["current"] = chol_blocked.chol_tile
        order = [k for k in versions if k != "current"]
        turns = order + ["current", "current"] + order[::-1]

        rng = np.random.default_rng(20240901)
        summary = {"card": card, "shapes": {}}
        for batch, n in chip_smoke.TIMED:
            M = chip_smoke.spd_batch(torch, rng, batch, n)
            Lp = chol_blocked.chol_tile_plain(M)
            row = {}
            for name, fn in versions.items():
                L = fn(M)
                torch.cuda.synchronize()
                rel = ((L - Lp).abs().max() / Lp.abs().max()).item()
                if not rel <= chip_smoke.KERNEL_TOL:
                    raise AssertionError(f"{name} disagrees with plain at ({batch},{n},{n}): {rel}")
                row[name] = {"rel_err": rel, "identical": torch.equal(L, Lp),
                             "queued_ms": [], "single_ms": []}
            for name in turns:
                row[name]["queued_ms"].append(chip_smoke.cuda_ms(torch, versions[name], M, inner=20))
                row[name]["single_ms"].append(chip_smoke.cuda_ms(torch, versions[name], M))
            row["cholesky_ex"] = {
                "queued_ms": [chip_smoke.cuda_ms(torch, torch.linalg.cholesky_ex, M, inner=20)],
                "single_ms": [chip_smoke.cuda_ms(torch, torch.linalg.cholesky_ex, M)],
            }
            bound_ms, bound_by = chip_smoke.chol_bound(batch, n)
            row["bound_ms"], row["bound_by"] = bound_ms, bound_by
            summary["shapes"][f"{batch}x{n}x{n}"] = row
            for name, rec in row.items():
                if isinstance(rec, dict):
                    print(f"({batch},{n},{n}) {name}: queued {rec['queued_ms']} ms, single "
                          f"{rec['single_ms']} ms, identical to plain: {rec.get('identical')}",
                          flush=True)
            print(f"({batch},{n},{n}) bound {bound_ms:.6f} ms ({bound_by})", flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
