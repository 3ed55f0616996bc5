"""Utilities around the solver: presolve warm start, checkpointed solves,
analytic FLOP counts and peak rates (``flops``), profiling and timing
(``profiling``)."""
