"""foundationpose_torch: the PyTorch / CUDA port of foundationpose_tpu.

Model-based register and track on one NVIDIA H100 (sm_90a). Plain tensor
code is PyTorch; the two Pallas kernels on that path are hand-written
CUDA (csrc/raster.cu, csrc/attention.cu), built at first use. CPU tensors
run each kernel's plain PyTorch version. The JAX package is the
reference; this package never imports JAX (mesh I/O is shared through
the numpy-only foundationpose_tpu.meshio).
"""

__version__ = "0.1.0"

from . import torch_config  # noqa: F401
from foundationpose_tpu.meshio import TriMesh, load_mesh  # noqa: F401


def __getattr__(name):
    if name == "FoundationPose":
        from .pipeline.estimator import FoundationPose

        return FoundationPose
    raise AttributeError(name)
