"""The arithmetic of the readers of the chunked solver's metrics
(``metrics/*.chunked.py``): sums over the window's requests of the counters
that ``entries/chunked_solver.py`` puts in each answer.  Each returns None
where the answers hold no such counter (a program without it) or where the
ratio has no base."""

from __future__ import annotations


def window_sum(run, key):
    """The counter ``key`` summed over the window's requests, or None."""
    if not run.requests or key not in run.requests[0].answer:
        return None
    return sum(float(r.answer[key][0]) for r in run.requests)


def fallback_share(run):
    """Percent of the window in host seconds of the rescue fallback's pass."""
    s = window_sum(run, "fallback_s")
    return None if s is None else 100.0 * s / run.window_s


def fallback_round_ms(run):
    """Host milliseconds of the fallback's pass over its rounds: one
    batched float64-rescue SQP iteration of the lanes it re-solves."""
    s, rounds = window_sum(run, "fallback_s"), window_sum(run, "fallback_rounds")
    return 1e3 * s / rounds if s is not None and rounds else None


def fallback_lanes_per_request(run):
    """Lanes handed to the rescue fallback, per request."""
    lanes = window_sum(run, "fallback_lanes")
    return None if lanes is None else lanes / len(run.requests)


def graph_hit_share(run):
    """Percent of the IPM's CUDA-graph launches over the window that replay
    a captured graph: replays / (replays + captures)."""
    rep, cap = window_sum(run, "graph_replays"), window_sum(run, "graph_captures")
    if rep is None or cap is None or rep + cap == 0:
        return None
    return 100.0 * rep / (rep + cap)
