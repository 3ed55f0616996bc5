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
reads no value on the host and makes no tensor from host data.
"""

from __future__ import annotations

import torch

from .._lanes import any_lane


class Eager:
    """Runs each stretch as a call; its outputs replace the slots."""

    graphed = False

    def __init__(self):
        self.slots: dict = {}

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
    """Runs each stretch from a CUDA graph, captured at its first run on a
    stream of its own.  ``tally`` gets ``graph_captures`` and
    ``graph_replays`` added to at every capture and replay; ``nbytes`` is
    the device memory the captures reserved."""

    graphed = True

    def __init__(self, device: torch.device, tally):
        super().__init__()
        self.device = device
        self.tally = tally
        self.graphs: dict = {}
        self.stream = None
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
        g = self.graphs.get(name)
        if g is None:
            self.graphs[name] = self._capture(fn)
            self.tally.graph_captures += 1
        else:
            g.replay()
            self.tally.graph_replays += 1

    def _capture(self, fn):
        """Capture ``fn`` and run it once; returns what replays it."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(current)
        reserved = torch.cuda.memory_reserved(self.device)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # one plain run first, on the capture stream: what is made lazily
            # at a first call (a cuBLAS workspace for this stream) is made
            # outside the capture
            fn(self.slots)
            g.capture_begin()
            try:
                _commit(self.slots, fn(self.slots))
            except BaseException:
                # end the broken capture; its own error hides the first one
                try:
                    g.capture_end()
                except RuntimeError:
                    pass
                raise
            g.capture_end()
        current.wait_stream(side)
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
