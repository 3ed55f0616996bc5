"""solve_s: see ``core.readers.solve_s``."""

from sqpbench.core.readers import solve_s as read  # noqa: F401
