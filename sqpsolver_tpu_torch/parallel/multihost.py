"""Multi-process execution on ``torch.distributed`` (torch port of the JAX
package's ``parallel/multihost.py``).

PyTorch's own idiom for several GPUs is one process per GPU, launched by
``torchrun --nproc_per_node=N`` (or spawned with ``WORLD_SIZE`` / ``RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT`` set, or given an ``init_method``):

* :func:`initialize_distributed` once per process (NCCL on the card, gloo
  only when the CPU is asked for);
* :func:`global_instance_mesh`: one device per rank, ``cuda:LOCAL_RANK``;
* ``host_local_batch`` (defined in ``sharding``, where ``solve_sharded``
  uses it too): each rank feeds its contiguous slice of the global batch
  (the counterpart of ``jax.make_array_from_process_local_data``);
* ``sharding.make_sharded_solver`` on that mesh solves the rank's lanes with
  no collective in the loop;
* :func:`convergence_census`: fleet-level counts, one ``all_reduce`` -- the
  only collective a batched solve needs.

In one process with no launcher, every entry point works as the JAX
package's single-process fallbacks do: :func:`initialize_distributed` is a
no-op and the mesh has one rank.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# host_local_batch lives in sharding (solve_sharded slices with it too) and is
# exported here, its home in the JAX package
from .sharding import Mesh, host_local_batch

__all__ = [
    "initialize_distributed", "global_instance_mesh", "host_local_batch",
    "convergence_census",
]


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(*, device=None, **kw) -> None:
    """Start the default process group under a multi-process launch.

    A no-op when the group is already up, or when the environment names no
    multi-process launch (``WORLD_SIZE`` unset or 1) and no ``kw`` is given.
    Otherwise ``init_process_group(backend, **kw)`` (``kw``: ``init_method``,
    ``world_size``, ``rank``, ...): NCCL for the card (``device=None``, and
    it raises where there is no card), gloo only for ``device="cpu"``.  On the
    card, ``cuda:LOCAL_RANK`` becomes the process's current device first."""
    if _group_up():
        return
    if not kw and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed: no CUDA device for the NCCL backend; pass "
                'device="cpu" to run the group on the CPU (gloo)'
            )
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend, **kw)


def global_instance_mesh(axis: str = "batch", *, device=None) -> Mesh:
    """1-D mesh of the whole job: this rank's one device (``cuda:LOCAL_RANK``;
    the CPU only for ``device="cpu"``) with its ``rank`` and the ``world``
    size (0 of 1 without a process group).  Raises where there is no card and
    none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and none was named: the global mesh "
                'puts each rank on its GPU; pass device="cpu" to run on the CPU'
            )
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    rank, world = (dist.get_rank(), dist.get_world_size()) if _group_up() else (0, 1)
    return Mesh(devices=(torch.device(device),), axis=axis, rank=rank, world=world)


def convergence_census(status, mesh: Optional[Mesh] = None) -> dict:
    """Fleet-level convergence counts: lanes in all, solved (status 0, 1 or
    6), infeasible (2) and the rest.

    A tensor is counted on its device; with a process group up, the counts of
    every rank are summed by one ``all_reduce(SUM)`` of an int64 tensor on
    that device (the rank's card under NCCL), the only collective a batched
    solve needs.  Host arrays take the numpy path.  ``mesh`` is ignored (the
    JAX package's signature); the group is the default one."""
    if torch.is_tensor(status):
        ok = torch.isin(status, torch.tensor([0, 1, 6], device=status.device))
        counts = torch.stack([
            torch.tensor(status.numel(), device=status.device),
            ok.sum(), (status == 2).sum(),
        ]).to(torch.int64)
        if _group_up():
            dist.all_reduce(counts, op=dist.ReduceOp.SUM)
        n_total, n_ok, n_inf = counts.tolist()
        return {
            "n_total": n_total,
            "n_done_ok": n_ok,
            "n_infeasible": n_inf,
            "n_other": n_total - n_ok - n_inf,
        }
    status = np.asarray(status)
    return {
        "n_total": int(status.size),
        "n_done_ok": int(np.isin(status, [0, 1, 6]).sum()),
        "n_infeasible": int((status == 2).sum()),
        "n_other": int((~np.isin(status, [0, 1, 2, 6])).sum()),
    }
