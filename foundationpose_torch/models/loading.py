"""Checkpoint loading that always pairs weights with their config.

Port of foundationpose_tpu/models/loading.py. The reference builds each
predictor from a run directory holding model_best.pth + config.yml and
applies backward-compat defaults in code (predict_pose_refine.py:93-141,
predict_score.py:117-157). :func:`load_estimator_checkpoint` is the one
entry point: it takes a `.npz` (converted by the JAX package's
cli.convert_weights with the reference config embedded, or written by
either package's FoundationPose.save_weights with its pipeline config
embedded, or bare) or a raw torch `.pth` (its sidecar config.yml found
beside it), and returns a state_dict for the port's nets together with
the typed config it was trained for, so a checkpoint with a non-default
config (6d rotation, BatchNorm, other normalizers) never runs under the
wrong settings.
"""
from __future__ import annotations

import dataclasses
import logging

logger = logging.getLogger(__name__)


def _has_bn(params: dict) -> bool:
    trunk = params.get("encodeA") or params.get("encoderA") or {}
    return "bn" in trunk.get("0", {})


def load_estimator_checkpoint(path: str, kind: str, base=None):
    """Load refiner or scorer weights from a `.npz` or a `.pth`.

    Returns (state_dict, cfg, zfar): `cfg` is a RefinerCfg / ScorerCfg
    from the checkpoint's reference config or embedded pipeline config
    when it has one, else `base` (the defaults) with use_bn read from the
    weights; `zfar` is the reference config's depth clamp, or None."""
    from ..pipeline.config import RefinerCfg, ScorerCfg
    from .convert import detect_use_bn, load_npz_params, load_torch_state_dict, params_from_jax
    from .reference_config import (
        find_sidecar_yaml,
        load_reference_yaml,
        refiner_cfg_from_reference,
        scorer_cfg_from_reference,
        zfar_from_reference,
    )

    if kind not in ("refiner", "scorer"):
        raise ValueError(f"kind must be 'refiner' or 'scorer', got {kind!r}")
    base = base or (RefinerCfg() if kind == "refiner" else ScorerCfg())
    from_ref = refiner_cfg_from_reference if kind == "refiner" else scorer_cfg_from_reference

    if path.endswith(".npz"):
        tree, meta = load_npz_params(path)
        meta = meta or {}
        raw = meta.get("reference_config")
        if raw is not None:
            cfg, zfar = from_ref(raw, base), zfar_from_reference(raw, kind)
        elif meta.get("pipeline_cfg") is not None:
            # FoundationPose.save_weights: the live config, scorer mode
            # included (a depth-mode scorer loads in depth mode).
            cfg, zfar = cfg_from_meta_dict(meta["pipeline_cfg"], base), None
        else:
            use_bn = meta.get("use_bn", _has_bn(tree))
            logger.info("%s %s: no embedded config; using the defaults (use_bn=%s)",
                        kind, path, use_bn)
            cfg, zfar = _fallback_cfg(base, kind, use_bn), None
        return params_from_jax(tree, cfg.net), cfg, zfar

    sd = load_torch_state_dict(path)
    ycfg = find_sidecar_yaml(path)
    if ycfg:
        raw = load_reference_yaml(ycfg)
        logger.info("%s: ingesting checkpoint config %s", kind, ycfg)
        return sd, from_ref(raw, base), zfar_from_reference(raw, kind)
    use_bn = detect_use_bn(sd)
    logger.info("%s %s: no sidecar config.yml; using the defaults (use_bn=%s)",
                kind, path, use_bn)
    return sd, _fallback_cfg(base, kind, use_bn), None


def cfg_from_meta_dict(d: dict, base):
    """Rebuild a RefinerCfg / ScorerCfg from its dataclasses.asdict dict
    (JSON round-tripped: lists come back as tuples, so the frozen config
    stays hashable); fields this package does not have are ignored."""
    d = dict(d)
    net_d = d.pop("net", None)
    raster_d = d.pop("raster", None)

    def coerce(cfg, upd):
        known = {f.name for f in dataclasses.fields(cfg)}
        upd = {k: tuple(v) if isinstance(v, list) else v for k, v in upd.items() if k in known}
        return dataclasses.replace(cfg, **upd)

    out = coerce(base, d)
    if net_d is not None:
        out = dataclasses.replace(out, net=coerce(base.net, net_d))
    if raster_d is not None:
        out = dataclasses.replace(out, raster=coerce(base.raster, raster_d))
    return out


def _fallback_cfg(base, kind: str, use_bn: bool):
    cfg = dataclasses.replace(base, net=dataclasses.replace(base.net, use_bn=use_bn))
    if kind == "scorer":
        cfg = dataclasses.replace(cfg, mode="network")  # weights imply network
    return cfg
