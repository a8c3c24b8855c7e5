from .. import torch_config  # noqa: F401
from .sharding import (
    HYP_AXIS,
    DATA_AXIS,
    DeviceMesh,
    make_device_mesh,
    batch_sharding,
    replicated,
    pad_to_multiple,
    shard_hypotheses,
    replicate_tree,
)
