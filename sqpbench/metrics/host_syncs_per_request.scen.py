"""host_syncs_per_request.scen: see ``core.readers.host_syncs_per_request``."""

from sqpbench.core.readers import host_syncs_per_request as read  # noqa: F401
