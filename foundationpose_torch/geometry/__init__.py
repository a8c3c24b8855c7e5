from .. import torch_config  # noqa: F401  (numerics policy)
from .rotations import (
    so3_exp_map,
    so3_log_map,
    rotation_6d_to_matrix,
    matrix_to_rotation_6d,
    euler_matrix,
    hat,
)
from .transforms import (
    transform_pts,
    normalize_rotation,
    make_pose,
    invert_pose,
    egocentric_delta_pose_to_pose,
)
from .projection import (
    project_points,
    depth_to_xyz_map,
    compute_crop_window_tf,
    invert_affine2d,
    guess_translation,
)
from .icosphere import icosphere, sample_views_icosphere
from .clustering import cluster_poses, cluster_poses_numpy
