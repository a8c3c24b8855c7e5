"""Checkpoint-shipped config ingestion (reference weights/<run>/config.yml).

Port of foundationpose_tpu/models/reference_config.py onto the port's
config dataclasses. The reference derives each predictor's architecture
and pipeline parameters from the OmegaConf YAML shipped next to the
checkpoint, with backward-compat defaults applied in code
(predict_pose_refine.py:102-131, predict_score.py:126-143). Released
checkpoints may therefore disagree with this framework's dataclass
defaults (6d rotation, different normalizers, BatchNorm, extra input
channels, ...); loading weights without their config would be silently
wrong. This module reproduces the reference's defaulting exactly and
maps the result onto the typed config tree (pipeline/config.py).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any

logger = logging.getLogger(__name__)

# Backward-compat defaults, field-for-field from
# predict_pose_refine.py:107-131 ...
REFINER_DEFAULTS: dict[str, Any] = {
    "use_normal": False,
    "use_mask": False,
    "use_BN": False,
    "c_in": 4,
    "crop_ratio": 1.2,
    "n_view": 1,
    "trans_rep": "tracknet",
    "rot_rep": "axis_angle",
    "zfar": 3,
    "normalize_xyz": False,
    "normal_uint8": False,
}
# ... and predict_score.py:126-143.
SCORER_DEFAULTS: dict[str, Any] = {
    "use_normal": False,
    "use_BN": False,
    "zfar": math.inf,
    "c_in": 4,
    "normalize_xyz": False,
    "crop_ratio": 1.2,
}


def load_reference_yaml(path: str) -> dict:
    """Load a checkpoint's config.yml (plain YAML; OmegaConf files are).
    Needs PyYAML; without it this raises ImportError, never falls back
    to default configs."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_reference_defaults(raw: dict, kind: str) -> dict:
    """Reproduce the reference's in-code backward-compat defaulting."""
    defaults = REFINER_DEFAULTS if kind == "refiner" else SCORER_DEFAULTS
    cfg = dict(raw)
    for k, v in defaults.items():
        if k not in cfg or (k == "crop_ratio" and cfg[k] is None):
            cfg[k] = v
    # zfar may be serialized as 'Infinity'/'.inf' strings
    # (predict_pose_refine.py:128-129)
    z = cfg.get("zfar")
    if isinstance(z, str) and "inf" in z.lower():
        cfg["zfar"] = math.inf
    return cfg


def _check_supported(cfg: dict, kind: str) -> None:
    expected_c_in = 9 if cfg.get("use_normal") else 6
    if cfg["c_in"] != expected_c_in:
        raise ValueError(
            f"{kind}: c_in={cfg['c_in']} inconsistent with "
            f"use_normal={bool(cfg.get('use_normal'))} (expected "
            f"{expected_c_in}; released checkpoints use 6 without normals)"
        )
    if cfg.get("use_mask"):
        raise ValueError(f"{kind}: use_mask checkpoints are not supported")
    if cfg.get("use_normal") and cfg.get("normal_uint8"):
        # normal_uint8 changes the normal-channel scaling at train time;
        # silently running such weights with float normals would be
        # wrong, so refuse loudly until the scaling is implemented.
        raise ValueError(
            f"{kind}: normal_uint8 checkpoints are not supported "
            "(normal channels would be wrongly scaled)"
        )
    if kind == "refiner" and cfg.get("n_view", 1) != 1:
        raise ValueError(f"refiner: n_view={cfg['n_view']} not supported")


def _input_res(cfg: dict, fallback: int) -> int:
    res = cfg.get("input_resize", [fallback, fallback])
    if isinstance(res, (list, tuple)):
        if len(res) != 2 or res[0] != res[1]:
            raise ValueError(f"non-square input_resize {res} not supported")
        return int(res[0])
    return int(res)


def _trans_normalizer(v) -> tuple[float, float, float]:
    # float or 3-list in the YAML (predict_pose_refine.py:178-180)
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    t = tuple(float(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"trans_normalizer must be a float or 3-list, got {v}")
    return t


def refiner_cfg_from_reference(raw: dict, base=None):
    """Map a refiner checkpoint config (after defaulting) to RefinerCfg."""
    from ..pipeline.config import RefinerCfg

    cfg = apply_reference_defaults(raw, "refiner")
    _check_supported(cfg, "refiner")
    base = base or RefinerCfg()
    net = dataclasses.replace(
        base.net,
        c_in=int(cfg["c_in"]),
        use_bn=bool(cfg["use_BN"]),
        rot_rep=str(cfg["rot_rep"]),
    )
    return dataclasses.replace(
        base,
        net=net,
        input_res=_input_res(cfg, base.input_res),
        crop_ratio=float(cfg["crop_ratio"]),
        trans_rep=str(cfg["trans_rep"]),
        rot_rep=str(cfg["rot_rep"]),
        use_normal=bool(cfg.get("use_normal")),
        normalize_xyz=bool(cfg["normalize_xyz"]),
        trans_normalizer=_trans_normalizer(
            cfg.get("trans_normalizer", base.trans_normalizer)
        ),
        rot_normalizer=float(cfg.get("rot_normalizer", base.rot_normalizer)),
    )


def scorer_cfg_from_reference(raw: dict, base=None):
    """Map a scorer checkpoint config (after defaulting) to ScorerCfg."""
    from ..pipeline.config import ScorerCfg

    cfg = apply_reference_defaults(raw, "scorer")
    _check_supported(cfg, "scorer")
    base = base or ScorerCfg()
    net = dataclasses.replace(
        base.net,
        c_in=int(cfg["c_in"]),
        use_bn=bool(cfg["use_BN"]),
    )
    return dataclasses.replace(
        base,
        net=net,
        input_res=_input_res(cfg, base.input_res),
        crop_ratio=float(cfg["crop_ratio"]),
        use_normal=bool(cfg.get("use_normal")),
        normalize_xyz=bool(cfg["normalize_xyz"]),
        mode="network",
    )


def zfar_from_reference(raw: dict, kind: str) -> float:
    return float(apply_reference_defaults(raw, kind)["zfar"])


def find_sidecar_yaml(ckpt_path: str) -> str | None:
    """The reference ships config.yml next to model_best.pth
    (predict_pose_refine.py:97-99)."""
    cand = os.path.join(os.path.dirname(os.path.abspath(ckpt_path)), "config.yml")
    return cand if os.path.isfile(cand) else None
