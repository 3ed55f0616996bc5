"""ipm_trip_ms.dispatch: see ``core.readers.ipm_trip_ms``."""

from sqpbench.core.readers import ipm_trip_ms as read  # noqa: F401
