"""solves_per_s: see ``core.readers.solves_per_s``."""

from sqpbench.core.readers import solves_per_s as read  # noqa: F401
