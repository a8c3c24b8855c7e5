from .. import torch_config  # noqa: F401
from .networks import (
    RefineNetCfg,
    ScoreNetCfg,
    RefineNet,
    ScoreNetMultiPair,
    init_refine_net,
    init_score_net,
    apply_refine_net,
    apply_score_net,
)
from .convert import (
    params_from_jax,
    params_to_jax,
    opt_state_from_jax,
    load_npz_params,
    load_torch_state_dict,
    detect_use_bn,
    convert_refine_net,
    convert_score_net,
    nerf_params_from_jax,
)
from .loading import load_estimator_checkpoint
from .training import (
    TrainCfg,
    make_optimizer,
    trainable_tensors,
    refine_loss_fn,
    score_loss_fn,
    refine_train_step,
    score_train_step,
)
from .reference_config import (
    apply_reference_defaults,
    load_reference_yaml,
    refiner_cfg_from_reference,
    scorer_cfg_from_reference,
    zfar_from_reference,
)
