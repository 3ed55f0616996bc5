"""setup_s: see ``core.readers.setup_s``."""

from sqpbench.core.readers import setup_s as read  # noqa: F401
