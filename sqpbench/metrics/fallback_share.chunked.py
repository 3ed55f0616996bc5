"""fallback_share.chunked: see ``core.chunked_readers.fallback_share``."""

from sqpbench.core.chunked_readers import fallback_share as read  # noqa: F401
