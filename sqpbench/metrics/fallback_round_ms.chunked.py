"""fallback_round_ms.chunked: see ``core.chunked_readers.fallback_round_ms``."""

from sqpbench.core.chunked_readers import fallback_round_ms as read  # noqa: F401
