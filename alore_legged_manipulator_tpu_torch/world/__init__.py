from .plant import PlantConfig, PlantState, plant_init, plant_step  # noqa: F401
from .grid_map import make_occupancy, paint_rect, paint_circle  # noqa: F401
