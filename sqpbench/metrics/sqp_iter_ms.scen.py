"""sqp_iter_ms.scen: see ``core.readers.sqp_iter_ms``."""

from sqpbench.core.readers import sqp_iter_ms as read  # noqa: F401
