"""What the benchmark reads from the program besides its answers: the
counters that its modules keep as globals, and the shapes of the
factorization kernel's launches."""

from __future__ import annotations

import contextlib


def counters() -> dict:
    """A snapshot of the program's counters: host syncs of the lane loops,
    batched interior-point trips and host seconds by phase, kernel launches
    and blocked factorizations."""
    from sqpsolver_tpu_torch._lanes import any_lane
    from sqpsolver_tpu_torch.ops import chol_blocked
    from sqpsolver_tpu_torch.ops.qp_ipm import solve_qp

    return dict(
        syncs=any_lane.syncs,
        ipm_trips=sum(solve_qp.loop_trips.values()),
        ipm_seconds=sum(solve_qp.phase_seconds.values()),
        chol_tile_launches=chol_blocked.chol_tile.launches,
        factorizations=chol_blocked.cholesky_blocked.calls,
    )


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


@contextlib.contextmanager
def chol_tile_shapes():
    """Record the (batch, n) of every ``chol_tile`` call while the block
    runs: the kernel's wrapper is looked up as a module global by its
    callers, so a recording wrapper stands in for it and is taken out on
    exit.  Yields the list of shapes."""
    from sqpsolver_tpu_torch.ops import chol_blocked

    inner = chol_blocked.chol_tile
    shapes: list = []

    def recording(M):
        shapes.append((int(M.shape[0]), int(M.shape[-1])))
        return inner(M)

    # the wrapper counts its launches on the global it finds under its name
    recording.launches = inner.launches
    chol_blocked.chol_tile = recording
    try:
        yield shapes
    finally:
        inner.launches = recording.launches
        chol_blocked.chol_tile = inner
