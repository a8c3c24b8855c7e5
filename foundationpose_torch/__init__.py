"""foundationpose_torch: the PyTorch / CUDA port of foundationpose_tpu.

Model-based register and track, and the model-free reconstruction
(nerf.run_neural_object_field), on one NVIDIA H100 (sm_90a). Plain tensor
code is PyTorch; the four Pallas kernels on those paths are hand-written
CUDA (csrc/raster.cu, csrc/attention.cu, csrc/segment_add.cu), built at
first use. CPU tensors run each kernel's plain PyTorch version. The JAX
package is the reference; this package imports neither JAX nor the JAX
package (meshio.py is its own copy of the numpy mesh helpers).
"""

__version__ = "0.1.0"

from . import torch_config  # noqa: F401
from .meshio import TriMesh, load_mesh  # noqa: F401


def __getattr__(name):
    if name == "FoundationPose":
        from .pipeline.estimator import FoundationPose

        return FoundationPose
    if name == "MultiTracker":
        from .pipeline.multi import MultiTracker

        return MultiTracker
    raise AttributeError(name)
