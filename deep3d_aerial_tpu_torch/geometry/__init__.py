from .camera import (
    AXIS_ROTATIONS,
    Camera,
    Pose,
    proj_matrix,
    qvec2rotmat,
    rotmat2qvec,
    scale_intrinsics,
    stage_proj_pyramid,
)

__all__ = [
    "AXIS_ROTATIONS",
    "Camera",
    "Pose",
    "proj_matrix",
    "qvec2rotmat",
    "rotmat2qvec",
    "scale_intrinsics",
    "stage_proj_pyramid",
]
