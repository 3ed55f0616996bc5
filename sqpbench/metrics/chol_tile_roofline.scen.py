"""chol_tile_roofline.scen: see ``core.readers.chol_tile_roofline``."""

from sqpbench.core.readers import chol_tile_roofline as read  # noqa: F401
