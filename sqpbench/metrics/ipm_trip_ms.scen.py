"""ipm_trip_ms.scen: see ``core.readers.ipm_trip_ms``."""

from sqpbench.core.readers import ipm_trip_ms as read  # noqa: F401
