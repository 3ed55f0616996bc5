"""A device trace of whole requests, reduced in the process: no trace file
is written.

The profiler (kineto, through ``torch.autograd.profiler``'s low-level entry
points, so that no event tree is built) records the device's kernels,
copies and fills over the traced stretch and the host's CUDA runtime calls;
not the host's operators, of which a long request holds millions (on a
machine without a card, where nothing else is there to record, it records
those).  The reduction gives the stretch's length, the seconds in which
some operation ran on the device (the union of their intervals), the device
time by operation name, and the longest idle gaps, each named by the
innermost host event that was running when the gap began.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class DeviceTrace:
    """Context manager: ``with DeviceTrace() as tr: ...`` then
    ``tr.summary`` (see :func:`reduce_events`)."""

    def __init__(self, device: torch.device, log=lambda msg: None):
        self.device = device
        self.log = log
        self.summary = None

    def __enter__(self):
        from torch.autograd.profiler import (
            ProfilerActivity, ProfilerConfig, ProfilerState, _enable_profiler,
            _ExperimentalConfig, _prepare_profiler,
        )

        if self.device.type == "cuda":
            acts = {ProfilerActivity.CUDA}
            torch.cuda.synchronize(self.device)
        else:
            acts = {ProfilerActivity.CPU}
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                             _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        from torch.autograd.profiler import _disable_profiler

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        t = time.perf_counter()
        result = _disable_profiler()
        self.log(f"trace: profiler stopped in {time.perf_counter() - t:.3f} s")
        if exc[0] is None:
            t = time.perf_counter()
            events = result.events()
            self.log(f"trace: {len(events)} events listed in {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            self.summary = reduce_events(events, self._t0, t1)
            self.log(f"trace: reduced in {time.perf_counter() - t:.3f} s")
        return False


def reduce_events(events, t0_ns: int, t1_ns: int) -> dict:
    """``window_s``: the traced stretch on the host clock; ``busy_s``: the
    union of the device operations' intervals; ``device_ops``: seconds by
    operation name (all of them); ``idle_gaps``: the ten longest idle
    stretches between device operations as (host event, seconds), the host
    event being the innermost one that spans the gap's start;
    ``device_events``: their count."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    d_start, d_end, h_start, h_end, h_name = [], [], [], [], []
    by_name: dict = {}
    for ev in events:
        dt = ev.device_type()
        if dt == cuda:
            s, d = ev.start_ns(), ev.duration_ns()
            d_start.append(s)
            d_end.append(s + d)
            name = ev.name()
            by_name[name] = by_name.get(name, 0) + d
        elif dt == cpu:
            d = ev.duration_ns()
            if d > 0:
                s = ev.start_ns()
                h_start.append(s)
                h_end.append(s + d)
                h_name.append(ev.name())
    window_ns = t1_ns - t0_ns
    busy_ns, named = 0, []
    if d_start:
        ds, de = np.asarray(d_start, np.int64), np.asarray(d_end, np.int64)
        order = np.argsort(ds, kind="stable")
        ds, de = ds[order], np.maximum.accumulate(de[order])
        # a new busy stretch starts where an operation begins after every
        # earlier one has ended
        new = np.concatenate([[True], ds[1:] > de[:-1]])
        starts, ends = ds[new], np.concatenate([de[:-1][new[1:]], de[-1:]])
        busy_ns = int((ends - starts).sum())
        gaps = starts[1:] - ends[:-1]
        hs, he = np.asarray(h_start, np.int64), np.asarray(h_end, np.int64)
        horder = np.argsort(hs, kind="stable")
        hs, he = hs[horder], he[horder]
        for g in np.argsort(-gaps, kind="stable")[:10]:
            at = ends[g]
            inner = "(no host event)"
            i = int(np.searchsorted(hs, at, side="right")) - 1
            for j in range(i, max(i - 100_000, -1), -1):
                if he[j] > at:
                    inner = h_name[horder[j]]
                    break
            named.append((inner, float(gaps[g]) * 1e-9))
        window_ns = max(window_ns, int(de[-1]) - min(t0_ns, int(ds[0])))
    return dict(
        window_s=window_ns * 1e-9, busy_s=busy_ns * 1e-9,
        device_ops={k: v * 1e-9 for k, v in by_name.items()},
        idle_gaps=named, device_events=len(d_start),
    )
