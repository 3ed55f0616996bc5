"""Batch-first helpers shared by the port's host-driven loops.

The JAX package writes each solver for ONE instance and batches it with
``jax.vmap``.  Under ``vmap`` a ``lax.while_loop`` runs until no lane wants
another trip; the body runs on every lane and a lane whose condition is
false keeps its state bit for bit.  The port writes the batch axis out
instead: a loop body runs on every lane, :func:`select` keeps the lanes whose
condition is false, and :func:`any_lane` is the loop's one host sync per trip
(counted in ``any_lane.syncs``).

Every tensor here carries the batch on its leading axis; a per-lane scalar
has shape ``(B,)``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def any_lane(mask: torch.Tensor) -> bool:
    """True when any lane of ``mask`` is set: the one host sync of a loop
    trip.  Each call adds one to ``any_lane.syncs``."""
    any_lane.syncs += 1
    return bool(mask.any().item())


any_lane.syncs = 0


@contextlib.contextmanager
def true_float32_matmul():
    """Turn TF32 off for float32 products (factors formed from TF32 products
    keep ~3 digits and spoil the refinement they seed); the caller's setting
    comes back on exit."""
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane ``where``: ``mask`` (B,) against tensors whose leading axis is
    the batch (the counterpart of ``jnp.where`` on a vmapped scalar)."""
    extra = a.dim() - mask.dim()
    return torch.where(mask.reshape(mask.shape + (1,) * extra), a, b)


def amax0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.max(x, axis=-1, initial=0.0)``: an empty row gives 0
    (``torch.amax`` raises on one)."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return torch.clamp_min(torch.amax(x, dim=-1), 0.0)


def amin_inf(x: torch.Tensor) -> torch.Tensor:
    """``jnp.min(x, axis=-1, initial=jnp.inf)``: an empty row gives +inf."""
    if x.shape[-1] == 0:
        return x.new_full(x.shape[:-1], float("inf"))
    return torch.amin(x, dim=-1)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``(B, m, n) @ (B, n) -> (B, m)``."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product over the last axis."""
    return (a * b).sum(-1)


def map_lanes(fn, tree, *rest):
    """Apply ``fn`` to every tensor of ``tree`` -- a tensor, ``None``, a dict,
    a NamedTuple or a dataclass of such (the solver state, the problem data,
    a result) -- and to the matching tensors of the trees in ``rest``;
    returns a tree of the same type.  The counterpart of ``jax.tree.map``."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_lanes(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: map_lanes(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            map_lanes(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)
        ))
    raise TypeError(f"map_lanes: unsupported node {type(tree).__name__}")


def gather_lanes(tree, idx: torch.Tensor):
    """The lanes ``idx`` (int64, on the tree's device) of every tensor."""
    return map_lanes(lambda a: a.index_select(0, idx), tree)


def scatter_lanes(full, slab, idx: torch.Tensor):
    """``full`` with its lanes ``idx`` replaced by those of ``slab`` (a copy;
    ``idx`` holds no lane twice, so the result does not depend on order)."""
    return map_lanes(lambda f, s: f.index_copy(0, idx, s), full, slab)
