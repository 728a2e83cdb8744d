from .colmap import ColmapCamera, ColmapImage, ColmapPoint3D, read_model
from .view_selection import (
    compute_scene_blocks,
    select_views,
)

__all__ = [
    "ColmapCamera",
    "ColmapImage",
    "ColmapPoint3D",
    "read_model",
    "compute_scene_blocks",
    "select_views",
]
