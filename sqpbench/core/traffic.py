"""The one traffic generator: load scenarios drawn from the parameters of
the mix's file.

A mix with a ``pool`` gives every seed the same set of requests in another
order: request ``i`` of the pool (``i`` below ``requests``) is drawn from
the pool's own seed and ``i``, and the run's seed sets the order in which
the closed loop goes through them.  The window runs whole passes of the
pool (``pool_size``), so every seed does the same work: a batch holding a
lane that stalls runs to the iteration limit and takes three to six times
as long as one that does not, and on the card which lanes stall moves with
the rounding of the batch (the order of the scenarios within a request
included), so a request's scenarios keep their drawn order.  A mix without
one draws each request from the run's seed and the request's index.
"""

from __future__ import annotations

import numpy as np

#: stream index of the order in which a run cycles through the pool
ORDER_STREAM = 2**32 - 3


def load_scenarios(bus_pd, bus_qd, batch: int, rng, spread: float) -> np.ndarray:
    """(batch, 2 nb) loads [pd, qd]: one multiplicative scale per scenario
    and a jitter of half its spread per bus.  Frozen copy of
    ``load_scenarios`` in sqpsolver_tpu_torch/models/acopf.py, taking a
    generator instead of a seed."""
    nb = len(bus_pd)
    scale = 1.0 + spread * (2.0 * rng.random((batch, 1)) - 1.0)
    jitter = 1.0 + 0.5 * spread * (2.0 * rng.random((batch, nb)) - 1.0)
    pd = bus_pd[None, :] * scale * jitter
    qd = bus_qd[None, :] * scale * jitter
    return np.concatenate([pd, qd], axis=1)


def pool_size(traffic: dict) -> int:
    """Requests in one pass of the pool; 1 for a mix without a pool."""
    pool = traffic.get("pool")
    return int(pool["requests"]) if pool else 1


def request_loads(net, traffic: dict, seed: int, index: int) -> np.ndarray:
    """The loads of request ``index`` of a run with ``seed``: the same pair
    gives the same loads."""
    lanes, spread = int(traffic["lanes"]), float(traffic["spread"])
    pool = traffic.get("pool")
    if not pool:
        rng = np.random.default_rng([int(seed), int(index)])
        return load_scenarios(net.pd, net.qd, lanes, rng, spread)
    order = np.random.default_rng([int(seed), ORDER_STREAM]).permutation(pool_size(traffic))
    rng = np.random.default_rng([int(pool["seed"]), int(order[index % len(order)])])
    return load_scenarios(net.pd, net.qd, lanes, rng, spread)


def warm_up_loads(net, traffic: dict) -> np.ndarray:
    """The warm-up request: every lane at the case's own loads, the same
    work whatever the seed."""
    base = np.concatenate([net.pd, net.qd])
    return np.tile(base, (int(traffic["lanes"]), 1))
