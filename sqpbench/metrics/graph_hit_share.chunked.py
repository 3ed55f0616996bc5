"""graph_hit_share.chunked: see ``core.chunked_readers.graph_hit_share``."""

from sqpbench.core.chunked_readers import graph_hit_share as read  # noqa: F401
