"""Stretches of device work between a loop's host points, run as plain calls
or replayed as CUDA graphs.

The interior-point trip (``ops/qp_ipm.py``) and the regularization ladder
(``ops/linsolve.py``) are written as *stretches*: functions from the named
tensors of a run (its *slots*) to new named tensors.  Between two stretches
stands a host point: a factorization call (:meth:`Eager.factor`) or a host
sync (:meth:`Eager.sync`, one ``any_lane``).

* :class:`Eager` calls each stretch and keeps its outputs as the new slots.
  The CPU, the structured operator and the card on request run this way.
* :class:`Graphed` captures each stretch into a ``torch.cuda.CUDAGraph`` the
  first time it runs and replays the graph afterwards.  Every slot is a
  tensor at a fixed address: a graph reads its inputs from the slots and
  writes its outputs into them (the first graph to produce a slot owns it).
  So any stretch may follow any other, and a ladder path first taken late in
  a solve is captured then.  Factorizations and syncs stay eager calls
  between the replays, as they are counted and recorded there.

A stretch must be a pure function of its slots: it writes nothing in place,
reads no value on the host and makes no tensor from host data.  A stretch
whose capture fails all the same (a model that makes a tensor from host data
at every call) runs as a plain call on the slots from then on.

Slots may also hold named *trees* (a tensor, None, a dict, a NamedTuple or a
dataclass of such, as the SQP state is): :meth:`Eager.load_trees` and
:meth:`Eager.tree_stretch` keep each tree's tensors under dotted names
(``st.x``, ``st.stats.f``) and rebuild the tree from them.

:class:`Plans` is the one policy of which graphed runs are kept: a cache of
one scope (the IPM trip's, process-wide; each SQP-TR solver's own) that
hands a caller the run for its device and named inputs.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from .._lanes import any_lane


#: a tensor's place in a tree's skeleton
_LEAF = object()


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if dataclasses.is_dataclass(tree):
        return ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return tree._asdict().items()


def _flatten(name: str, tree, out: dict) -> None:
    if torch.is_tensor(tree):
        out[name] = tree
    elif tree is not None:
        for k, v in _items(tree):
            _flatten(f"{name}.{k}", v, out)


def flat_trees(trees: dict) -> dict:
    """The tensors of named trees under their dotted slot names."""
    out: dict = {}
    for name, tree in trees.items():
        _flatten(name, tree, out)
    return out


def _skeleton(tree):
    """The tree with :data:`_LEAF` in place of each tensor."""
    if torch.is_tensor(tree):
        return _LEAF
    if tree is None:
        return None
    parts = {k: _skeleton(v) for k, v in _items(tree)}
    return parts if isinstance(tree, dict) else type(tree)(**parts)


def _rebuild(name: str, skel, slots: dict):
    if skel is _LEAF:
        return slots[name]
    if skel is None:
        return None
    parts = {k: _rebuild(f"{name}.{k}", v, slots) for k, v in _items(skel)}
    return parts if isinstance(skel, dict) else type(skel)(**parts)


class Eager:
    """Runs each stretch as a call; its outputs replace the slots."""

    graphed = False

    def __init__(self):
        self.slots: dict = {}
        #: the skeleton of each named tree in the slots
        self.skeletons: dict = {}

    def load(self, tensors: dict) -> None:
        """Set the named inputs of a run."""
        self.slots.update(tensors)

    def stretch(self, name: str, fn) -> None:
        """Run the stretch ``fn`` (slots -> dict of outputs) under ``name``."""
        self.slots.update(fn(self.slots))

    def factor(self, chol, src: str, dst: str) -> None:
        """The host point of a factorization: ``dst = chol(src)``."""
        self.slots[dst] = chol(self.slots[src])

    def sync(self, name: str) -> bool:
        """The host point of a sync: whether any lane of the mask is set."""
        return any_lane(self.slots[name])

    def export(self, t: torch.Tensor) -> torch.Tensor:
        """A slot's value as the caller may keep it."""
        return t

    def load_trees(self, trees: dict) -> None:
        """Set named trees as inputs of a run."""
        self.skeletons.update((name, _skeleton(tree)) for name, tree in trees.items())
        self.load(flat_trees(trees))

    def tree(self, name: str, slots: dict = None):
        """The named tree (or plain slot) as the slots hold it."""
        slots = self.slots if slots is None else slots
        return _rebuild(name, self.skeletons.get(name, _LEAF), slots)

    def tree_stretch(self, name: str, fn) -> None:
        """Run the stretch ``fn`` under ``name``: ``fn`` gets a reader of
        named trees and returns a dict of named trees."""

        def flat_fn(slots):
            trees = fn(lambda key: self.tree(key, slots))
            self.skeletons.update((k, _skeleton(tree)) for k, tree in trees.items())
            return flat_trees(trees)

        self.stretch(name, flat_fn)

    def export_tree(self, name: str):
        """A named tree as the caller may keep it."""
        flat = flat_trees({name: self.tree(name)})
        return _rebuild(name, self.skeletons[name], {k: self.export(v) for k, v in flat.items()})


#: the stream that every capture on a device runs on: what a first call
#: makes lazily for a stream (a cuBLAS workspace, tens of MB on this card)
#: is made once, not once for each run of graphs
_CAPTURE_STREAMS: dict = {}


class _CaptureFailed(RuntimeError):
    """A stretch that runs as a plain call could not be captured."""


def _end_capture(g):
    """End ``g``'s capture; the error that ending it raised, or None."""
    try:
        g.capture_end()
    except RuntimeError as err:
        return err
    return None


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _expanded(t: torch.Tensor) -> bool:
    return any(st == 0 and sz > 1 for st, sz in zip(t.stride(), t.shape))


def _own(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in memory of its own, laid out as ``t`` is (a
    product's rounding may depend on its operands' layout); an expanded
    tensor comes back contiguous."""
    if _expanded(t):
        return t.clone(memory_format=torch.contiguous_format)
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)


def _commit(slots: dict, out: dict) -> None:
    """Write a stretch's outputs into the slots, inside its capture: a new
    name adopts the output tensor as its slot; a known name gets a copy.
    Outputs that share memory with a slot (a slot passed on under another
    name, a view of one) or with an adopted output, and expanded outputs,
    are copied first, so that no write of this stretch lands in a tensor
    that another slot reads."""
    held = {_storage(t) for t in slots.values()}
    staged = []
    for k, v in out.items():
        if v is slots.get(k):
            continue
        if _storage(v) in held or _expanded(v):
            v = _own(v)
        if k not in slots:
            held.add(_storage(v))
        staged.append((k, v))
    for k, v in staged:
        if k in slots:
            slots[k].copy_(v)
        else:
            slots[k] = v


class Graphed(Eager):
    """Runs each stretch from a CUDA graph, captured at its first run on the
    device's capture stream.  ``tally`` gets ``graph_captures`` and
    ``graph_replays`` added to at every capture and replay; ``nbytes`` is
    the device memory the captures reserved."""

    graphed = True

    def __init__(self, device: torch.device, tally):
        super().__init__()
        self.device = device
        self.tally = tally
        self.graphs: dict = {}
        self.nbytes = 0

    @staticmethod
    def runs_on(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def device_memory(device: torch.device) -> int:
        return torch.cuda.get_device_properties(device).total_memory

    def load(self, tensors: dict) -> None:
        """Copy the named inputs into their slots (made at the first load)."""
        for k, v in tensors.items():
            slot = self.slots.get(k)
            if slot is None:
                self.slots[k] = _own(v)
            else:
                slot.copy_(v)

    def stretch(self, name: str, fn) -> None:
        if name not in self.graphs:
            try:
                self.graphs[name] = self._capture(fn)
                self.tally.graph_captures += 1
                return
            except _CaptureFailed:
                self.graphs[name] = None
        g = self.graphs[name]
        if g is None:  # its capture failed: a plain call on the slots
            _commit(self.slots, fn(self.slots))
        else:
            g.replay()
            self.tally.graph_replays += 1

    def _capture(self, fn):
        """Capture ``fn`` and run it once; returns what replays it.  Raises
        :class:`_CaptureFailed`, with nothing run, where only the capture
        fails."""
        side = _CAPTURE_STREAMS.get(self.device)
        if side is None:
            side = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        reserved = torch.cuda.memory_reserved(self.device)
        g = torch.cuda.CUDAGraph()
        before = set(self.slots)
        try:
            with torch.cuda.stream(side):
                # one plain run first, on the capture stream: what is made
                # lazily at a first call (a cuBLAS workspace for this stream,
                # a model's constants) is made outside the capture
                fn(self.slots)
                g.capture_begin()
                try:
                    _commit(self.slots, fn(self.slots))
                    failure = None
                except RuntimeError as err:
                    failure = err
                finally:
                    # a failed capture ends too; ending reports what
                    # invalidated one
                    end_failure = _end_capture(g)
                failure = failure or end_failure
        finally:
            current.wait_stream(side)
        if failure is not None:
            for k in set(self.slots) - before:
                del self.slots[k]
            raise _CaptureFailed from failure
        self.nbytes += max(0, torch.cuda.memory_reserved(self.device) - reserved)
        g.replay()
        return g

    def factor(self, chol, src: str, dst: str) -> None:
        L = chol(self.slots[src])
        slot = self.slots.get(dst)
        if slot is None:
            self.slots[dst] = L
        else:
            slot.copy_(L)

    def export(self, t: torch.Tensor) -> torch.Tensor:
        return t.clone()


#: the share of the card's memory that the captures of one :class:`Plans`
#: may hold
_MEMORY_SHARE = 0.125


class Plans(OrderedDict):
    """Graphed runs of one scope, least recently used first, keyed by what
    their graphs depend on: the device, the float32 matmul precision, the
    caller's key, and each named tensor's name, dtype, shape and strides.
    Each run counts into ``tally``.  The least recently used run goes while
    more than one is kept and the cache holds more than ``limit`` runs (no
    limit when None) or its captures more than :data:`_MEMORY_SHARE` of the
    card's memory."""

    #: False runs every stretch as a plain call (for tests; set on an
    #: instance for one cache, on the class for every cache)
    graphs = True

    def __init__(self, tally, limit: int | None = None):
        super().__init__()
        self.tally = tally
        self.limit = limit

    def run(self, device: torch.device, key, tensors: dict) -> Eager:
        """The run for ``tensors`` on ``device``: the kept graphed run of
        this key, a new one, or plain calls where graphs are off or the
        device cannot run them."""
        if not (self.graphs and Graphed.runs_on(device)):
            return Eager()
        key = (
            device, torch.get_float32_matmul_precision(), key,
            tuple((k, v.dtype, tuple(v.shape), v.stride()) for k, v in tensors.items()),
        )
        run = self.pop(key, None) or Graphed(device, self.tally)
        self[key] = run
        budget = _MEMORY_SHARE * Graphed.device_memory(device)
        while len(self) > 1 and (
            (self.limit is not None and len(self) > self.limit)
            or sum(r.nbytes for r in self.values()) > budget
        ):
            self.popitem(last=False)
        return run
