"""fallback_lanes_per_request.chunked: see ``core.chunked_readers.fallback_lanes_per_request``."""

from sqpbench.core.chunked_readers import fallback_lanes_per_request as read  # noqa: F401
