from .. import torch_config  # noqa: F401
from .networks import (
    RefineNetCfg,
    ScoreNetCfg,
    RefineNet,
    ScoreNetMultiPair,
    init_refine_net,
    init_score_net,
)
from .convert import params_from_jax, load_npz_params
