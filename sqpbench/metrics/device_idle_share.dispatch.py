"""device_idle_share.dispatch: see ``core.readers.device_idle_share``."""

from sqpbench.core.readers import device_idle_share as read  # noqa: F401
