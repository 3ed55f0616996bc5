"""One case118 KKT trip under the float32 matrix plane and under ``mixed_ir``,
in the port on the card and in the JAX package on the CPU.

``chip_smoke.py`` phase 18 times one ``DenseOp.prepare`` + ``solve_block`` of
the first QP of real case118 b16 at its start point and measures each
result's error against a float64 solve.  This script asks whether what it
finds there is the port's or the method's, in two steps:

* ``--capture OUT.npz`` (on a machine with a CUDA card): the same capture
  as phase 18 (``chip_smoke.capture_case118_kkt``), and its first IPM trip's
  ``Q``, ``A``, the ``prepare`` arguments, the right-hand side and the
  port's plane and ``mixed_ir`` results on the card written to ``OUT.npz``;
* ``--compare IN.npz`` (on the CPU, with the JAX package): the same trip
  through the JAX package's vmapped ``DenseOp`` (``kkt_backend="xla"``) and
  the port's on the CPU, under both precisions, each lane's
  max|v - x| / max|x| against a float64 LAPACK solve of the same system
  printed beside the card's.

Usage::

    python3 scripts/torch_plane_trip.py --capture trip118.npz   # with a CUDA card
    JAX_PLATFORMS=cpu python scripts/torch_plane_trip.py --compare trip118.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ("diag_k", "invE_soft", "stiff", "E_stiff", "delta0")
PRECISIONS = {"plane": True, "mixed_ir": False}


def capture(out_path: str) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from sqpsolver_tpu_torch.ops import _build
    from sqpsolver_tpu_torch.ops.qp_ipm import DenseOp

    torch.set_float32_matmul_precision("highest")
    _build.build("chol_tile")
    trip = chip_smoke.capture_case118_kkt(torch)[0]
    op = trip["op"]
    out = {"Q": op.Q, "A": op.A, **dict(zip(ARGS, trip["args"])), "r1": trip["rhs"][0],
           "r2": trip["rhs"][1]}
    for name, plane in PRECISIONS.items():
        twin = DenseOp(op.Q, op.A, dataclasses.replace(op.opts, plane=plane), torch.float64)
        solve_block, _ = twin.prepare(*trip["args"])
        out[f"card_{name}_dp"], out[f"card_{name}_dy"] = solve_block(*trip["rhs"])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["opts"] = np.array(repr(op.opts))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **out)
    print(f"{out_path}: first IPM trip of case118 b16, {torch.cuda.get_device_name(0)}")


def compare(in_path: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from sqpsolver_tpu.ops import qp_ipm as j_qp
    from sqpsolver_tpu_torch.ops import qp_ipm as t_qp

    z = np.load(in_path)
    Q, A = z["Q"], z["A"]
    dk, iE, st, Es, d0 = (z[k] for k in ARGS)
    r1, r2 = z["r1"], z["r2"]
    B, m, n = A.shape
    ref = []
    for b in range(B):
        K = Q[b] + np.diag(dk[b]) + (A[b].T * iE[b]) @ A[b]
        At = np.where(st[b][:, None], A[b], 0.0)
        KKT = np.block([[K, At.T], [At, -np.diag(Es[b])]])
        ref.append(np.linalg.solve(KKT, np.concatenate([r1[b], r2[b]])))
    print(f"case118 b{B} first IPM trip (n={n}, m={m}); {z['opts']}")
    for name, plane in PRECISIONS.items():
        kw = dict(factor_dtype="float32", ir_steps=4, kkt_backend="xla", plane=plane,
                  invert_factors=True, invE_floor=3e-7, schur_cap=336)
        j_opts, t_opts = j_qp.IpmOptions(**kw), t_qp.IpmOptions(**kw)

        def lane(*a):
            solve_block, _ = j_qp.DenseOp(a[0], a[1], j_opts, jnp.float64).prepare(*a[2:7])
            return solve_block(a[7], a[8])

        got = {"JAX (cpu, xla)": jax.jit(jax.vmap(lane))(
            *(jnp.asarray(a) for a in (Q, A, dk, iE, st, Es, d0, r1, r2)))}
        T = [torch.as_tensor(a) for a in (Q, A, dk, iE, st, Es, d0, r1, r2)]
        solve_block, _ = t_qp.DenseOp(T[0], T[1], t_opts, torch.float64).prepare(*T[2:7])
        got["port (cpu, xla)"] = solve_block(T[7], T[8])
        got["port (card, pallas)"] = (z[f"card_{name}_dp"], z[f"card_{name}_dy"])
        for who, (dp, dy) in got.items():
            v = np.concatenate([np.asarray(dp), np.asarray(dy)], -1)
            err = [np.abs(v[b] - ref[b]).max() / np.abs(ref[b]).max() for b in range(B)]
            print(f"{name:9s} {who:20s} error against float64 per lane: min {min(err):.3e} "
                  f"median {np.median(err):.3e} max {max(err):.3e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--capture", metavar="OUT.npz")
    group.add_argument("--compare", metavar="IN.npz")
    args = ap.parse_args()
    if args.capture:
        capture(args.capture)
    else:
        compare(args.compare)


if __name__ == "__main__":
    main()
