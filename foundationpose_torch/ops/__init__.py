from .. import torch_config  # noqa: F401
from .depth_filters import erode_depth, bilateral_filter_depth
from .warp import warp_perspective, warp_perspective_batch, warp_crop
from .rasterizer import render_mesh, render_mesh_brute, RenderOutput
from .attention import attention_core, attention_core_plain
