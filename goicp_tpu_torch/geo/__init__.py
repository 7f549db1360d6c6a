from goicp_tpu_torch.geo.procrustes import horn_quaternion, procrustes
from goicp_tpu_torch.geo.rotation import (
    axis_angle_cube_max_angle,
    axis_angle_rotation,
    quat_to_matrix,
    random_rotations,
    rotation_displacement,
)

__all__ = [
    "axis_angle_cube_max_angle",
    "axis_angle_rotation",
    "horn_quaternion",
    "procrustes",
    "quat_to_matrix",
    "random_rotations",
    "rotation_displacement",
]
