"""Multi-device solves (torch port of the JAX package's
``parallel/sharding.py``).

Two layouts, as in the JAX package:

* **Instance sharding** (:func:`make_sharded_solver`): the lane axis of a
  batch is cut into contiguous equal slices, one per mesh device; each slice
  goes through ``make_batch_solver`` on its device, and the results are
  concatenated on ``mesh.devices[0]`` (JAX's "final gather").  Every
  instance's SQP state lives on one device, so the hot loop has no
  collective.
* **Block sharding of one structured instance**
  (:func:`make_block_sharded_solver`): the BBD part axis is split over the
  mesh (``ops.kkt_bbd.part_groups``); each part group's interior
  factorization runs on its device and the separator terms are summed onto
  ``mesh.devices[0]``.

**The shards of one process run in turn, on one host thread, by design.**
The solve's state is process-global: each solve sets and restores the
global float32 matmul precision (``_lanes.true_float32_matmul``;
a second thread would switch TF32 back on in the middle of another solve),
and the counters ``_lanes.any_lane.syncs``, ``ops.qp_ipm.solve_qp.loop_trips``
and ``phase_seconds`` are plain globals.  So one process does not run its
GPUs concurrently.  PyTorch runs several GPUs at once with one process per
GPU: launch with ``torchrun --nproc_per_node=N`` and build the mesh with
``parallel.multihost.global_instance_mesh``; each rank then solves its own
lanes on its own card, and ``multihost.convergence_census`` is the one
collective.

A mesh's devices may repeat (``["cuda:0", "cuda:0"]``, ``["cpu"] * 8``): the
counterpart of the JAX package's fake 8-device CPU mesh, which the tests use.

The ``axis`` arguments of the public functions keep the JAX package's
signatures, where they name a ``PartitionSpec`` axis; here a mesh has one
axis, and ``axis`` is only stored on the :class:`Mesh` that
:func:`instance_mesh` builds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from .._lanes import map_lanes
from ..algorithms.sqp_tr import SqpResult, make_solver
from ..nlp import NLP, NLPData
from ..parameters import Parameters
from .batch import batch_data, make_batch_solver


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of this process's shards, in order, and the
    process's place in a multi-process job (``rank`` of ``world``; 0 of 1
    in one process)."""

    devices: tuple
    axis: str = "batch"
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Shards in the whole job: this process's devices times the
        processes."""
        return len(self.devices) * self.world


class ShardedData(NamedTuple):
    """A batch cut along its lane axis: ``shards[i]`` (an :class:`NLPData`)
    on ``mesh.devices[i]``, this process's contiguous lanes of
    ``global_batch`` in all."""

    shards: tuple
    global_batch: int


def instance_mesh(devices: Optional[Sequence] = None, axis: str = "batch") -> Mesh:
    """1-D mesh over the instance axis.  ``None`` is every CUDA device, and
    raises where there is none; the CPU only when named (``["cpu"] * 8``).
    Devices may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and none was named: instance_mesh() "
                'spans the GPUs; name devices (e.g. ["cpu"] * 8) to run elsewhere'
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices=devices, axis=axis)


def _to(tree, device):
    return map_lanes(lambda a: a.to(device), tree)


def shard_data(data: NLPData, mesh: Mesh, axis: str = "batch") -> ShardedData:
    """Cut batched NLPData into ``len(mesh.devices)`` contiguous equal slices
    of the lane axis, each on its device.  ``axis`` is ignored (the JAX
    package's signature)."""
    B = int(data.x0.shape[0])
    k = len(mesh.devices)
    if B % k:
        raise ValueError(f"batch {B} not divisible by the mesh's {k} devices")
    w = B // k
    shards = tuple(
        _to(map_lanes(lambda a: a[i * w:(i + 1) * w], data), dev)
        for i, dev in enumerate(mesh.devices)
    )
    return ShardedData(shards=shards, global_batch=B)


def host_local_batch(local_data: NLPData, mesh: Mesh, axis: str = "batch") -> ShardedData:
    """This rank's contiguous slice of the global batch, on its device(s),
    tagged with the global lane count (the counterpart of
    ``jax.make_array_from_process_local_data``).

    ``local_data`` is batched NLPData holding this rank's lanes only; every
    rank holds as many, so the global batch is ``world`` times the local one
    and this rank's lanes start at ``rank`` times it.  ``axis`` is ignored
    (the JAX package's signature)."""
    local = int(local_data.x0.shape[0])
    return shard_data(local_data, mesh)._replace(global_batch=local * mesh.world)


def _concat(results, device):
    """Lane-wise concatenation of per-shard results on ``device``."""
    first = results[0]
    return map_lanes(
        lambda *parts: torch.cat([p.to(device) for p in parts], dim=0), first, *results[1:]
    )


def make_sharded_solver(
    nlp: NLP,
    params: Parameters = Parameters(),
    mesh: Optional[Mesh] = None,
    axis: str = "batch",
) -> Callable[[Union[NLPData, ShardedData]], SqpResult]:
    """Batched solver whose instance axis is sharded over ``mesh``.

    The returned function takes :class:`ShardedData` (:func:`shard_data`,
    or ``multihost.host_local_batch`` on a multi-process mesh) or batched
    NLPData, which it shards itself (its lane count a multiple of the mesh's
    devices).  Each shard is solved by ``make_batch_solver`` on its device,
    in turn (see the module docstring), and the results are concatenated on
    ``mesh.devices[0]``: this process's lanes, in order.  ``axis`` names the
    axis of the mesh built when ``mesh`` is None."""
    mesh = mesh or instance_mesh(axis=axis)
    solver = make_batch_solver(nlp, params)

    def solve(data) -> SqpResult:
        if isinstance(data, NLPData):
            data = shard_data(data, mesh)
        return _concat([solver(shard) for shard in data.shards], mesh.devices[0])

    return solve


def make_block_sharded_solver(
    nlp: NLP,
    params: Parameters,
    mesh: Optional[Mesh] = None,
    axis: str = "block",
) -> Callable[[NLPData], SqpResult]:
    """Solver of ONE large structured instance (batched NLPData, usually of
    one lane) with its BBD part axis sharded over the mesh.

    Requires ``params.kkt_structured=True`` and ``nlp.structure``, and
    ``params.kkt_parts`` a multiple of the mesh size (0, the partition's own
    count, is; the partition may return more parts than asked for, and the
    groups then differ by one part).  The lanes, the block assembly, the separator and the
    stiff Schur complement live on ``mesh.devices[0]``, where the data is
    moved; each part group's interiors are factored on its device, and its
    separator term is summed onto ``mesh.devices[0]``.  The blocks are
    assembled on ``mesh.devices[0]`` and each group's slices are copied to
    its device and back on every factorization and solve, so this layout
    makes no solve faster yet: it is the layout, not a speed-up (its one-card
    times are in ``PERF.md``).  Intended use: a cross-scenario coupled NLP
    (``models.stochastic``) whose scenario blocks spread over the devices.
    ``axis`` names the axis of the mesh built when ``mesh`` is None."""
    if not params.kkt_structured:
        raise ValueError("block sharding requires kkt_structured=True")
    mesh = mesh or instance_mesh(axis=axis)
    core = make_solver(nlp, params, verbose=False, block_shard=mesh)

    def solve(data: NLPData) -> SqpResult:
        return core(_to(data, mesh.devices[0]))

    return solve


def solve_sharded(
    nlp: NLP,
    params: Parameters,
    batch: int,
    *,
    theta=None,
    mesh: Optional[Mesh] = None,
    axis: str = "batch",
) -> SqpResult:
    """End-to-end sharded batched solve: build data, shard, solve.  On a
    multi-process mesh ``batch`` is the global lane count and this process
    solves its contiguous share (its ``rank``-th of ``world``, through
    :func:`host_local_batch`).  ``axis`` names the axis of the mesh built
    when ``mesh`` is None."""
    mesh = mesh or instance_mesh(axis=axis)
    if batch % mesh.size != 0:
        raise ValueError(f"batch {batch} not divisible by mesh size {mesh.size}")
    dtype = torch.float64 if params.dtype == "float64" else torch.float32
    data = batch_data(nlp, batch, theta=theta, dtype=dtype, device=mesh.devices[0])
    local = batch // mesh.world
    lo = mesh.rank * local
    data = map_lanes(lambda a: a[lo:lo + local], data)
    return make_sharded_solver(nlp, params, mesh)(host_local_batch(data, mesh))
