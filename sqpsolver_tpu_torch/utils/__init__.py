"""Utilities around the solver: presolve warm start, checkpointed solves."""
