from .. import torch_config  # noqa: F401
from .config import EstimatorCfg, RefinerCfg, ScorerCfg, RasterCfg
from .mesh_tensors import MeshTensors, make_mesh_tensors
from .crops import make_crop_inputs
from .refiner import refine_poses, apply_pose_delta
from .scorer import score_poses, score_poses_tournament
from .estimator import FoundationPose
