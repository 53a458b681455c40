"""Crop geometry, epipolar geometry and pose algebra (port of
pope_tpu/geometry: the parts the retrieve -> match -> solve stage and the
matcher's validation and the regressor use)."""

from pope_tpu_torch.geometry.affine import (
    crop_resize_bilinear,
    get_affine_transform,
    get_image_crop_resize,
    get_K_crop_resize,
)
from pope_tpu_torch.geometry.epipolar import (
    compute_symmetric_epipolar_errors,
    essential_from_Rt,
    normalize_keypoints,
    sampson_distance,
    symmetric_epipolar_distance,
    triangulate_midpoint,
)
from pope_tpu_torch.geometry.pose import (
    geodesic_distance,
    matrix_to_quat,
    o6d_to_matrix,
    pose_compose,
    pose_inverse,
    project_points,
    quat_to_matrix,
    relative_pose,
    relative_pose_error,
    rotation_angle_deg,
    skew,
    to_homo_pose,
    translation_angle_deg,
)
