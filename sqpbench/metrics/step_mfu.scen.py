"""step_mfu.scen: see ``core.readers.step_mfu``."""

from sqpbench.core.readers import step_mfu as read  # noqa: F401
