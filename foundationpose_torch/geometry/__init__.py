from .. import torch_config  # noqa: F401  (numerics policy)
from .rotations import (
    so3_exp_map,
    so3_log_map,
    rotation_6d_to_matrix,
    matrix_to_rotation_6d,
    euler_matrix,
    hat,
    rot_x,
    rot_y,
    rot_z,
)
from .transforms import (
    to_homo,
    transform_pts,
    transform_dirs,
    normalize_rotation,
    make_pose,
    invert_pose,
    pose_to_egocentric_delta_pose,
    egocentric_delta_pose_to_pose,
)
from .projection import (
    GLCAM_IN_CVCAM,
    project_points,
    depth_to_xyz_map,
    compute_crop_window_tf,
    invert_affine2d,
    guess_translation,
    projection_matrix_from_intrinsics,
)
from .icosphere import icosphere, sample_views_icosphere
from .clustering import cluster_poses, cluster_poses_numpy
from .symmetry import symmetry_tfs_from_info
