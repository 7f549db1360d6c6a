from goicp_tpu_torch.geo.normals import estimate_normals
from goicp_tpu_torch.geo.procrustes import horn_quaternion, procrustes
from goicp_tpu_torch.geo.rotation import (
    axis_angle_cube_max_angle,
    axis_angle_in_ball,
    axis_angle_max_angle,
    axis_angle_rotation,
    quat_cube_in_SO3,
    quat_cube_max_angle,
    quat_cube_overlaps_SO3,
    quat_cube_rotation,
    quat_to_matrix,
    random_rotations,
    rotation_displacement,
)

__all__ = [
    "axis_angle_cube_max_angle",
    "axis_angle_in_ball",
    "axis_angle_max_angle",
    "axis_angle_rotation",
    "estimate_normals",
    "horn_quaternion",
    "procrustes",
    "quat_cube_in_SO3",
    "quat_cube_max_angle",
    "quat_cube_overlaps_SO3",
    "quat_cube_rotation",
    "quat_to_matrix",
    "random_rotations",
    "rotation_displacement",
]
