"""One-shot conversion of the reference's torch checkpoints to `.npz`.

Port of foundationpose_tpu/cli/convert_weights.py, with the same flags
and the same files: `<out_dir>/refiner.npz` / `scorer.npz`, the JAX
package's param tree (`models.convert.convert_refine_net` /
`convert_score_net`) with meta `kind`,
`use_bn` and, where the checkpoint shipped a config.yml (next to the
`.pth`, or given by --*_config), the resolved `reference_config`. Either
package's `load_weights` reads them.

    python -m foundationpose_torch.cli.convert_weights \
        --refiner_ckpt weights/.../model_best.pth --out_dir weights_npz
"""
from __future__ import annotations

import argparse
import logging
import math
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--refiner_ckpt", type=str, default=None)
    parser.add_argument("--scorer_ckpt", type=str, default=None)
    parser.add_argument("--refiner_config", type=str, default=None,
                        help="checkpoint config.yml (default: the one next to the .pth)")
    parser.add_argument("--scorer_config", type=str, default=None)
    parser.add_argument("--out_dir", type=str, required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not (args.refiner_ckpt or args.scorer_ckpt):
        parser.error("pass --refiner_ckpt and/or --scorer_ckpt")

    from ..models.convert import (
        convert_refine_net,
        convert_score_net,
        detect_use_bn,
        load_torch_state_dict,
    )
    from ..models.reference_config import (
        apply_reference_defaults,
        find_sidecar_yaml,
        load_reference_yaml,
        refiner_cfg_from_reference,
        scorer_cfg_from_reference,
    )
    from ..utils.checkpoint import save_params

    os.makedirs(args.out_dir, exist_ok=True)
    for ckpt, cfg_path, convert, name in (
        (args.refiner_ckpt, args.refiner_config, convert_refine_net, "refiner"),
        (args.scorer_ckpt, args.scorer_config, convert_score_net, "scorer"),
    ):
        if not ckpt:
            continue
        cfg_path = cfg_path or find_sidecar_yaml(ckpt)
        sd = load_torch_state_dict(ckpt)
        use_bn = detect_use_bn(sd)
        try:
            params = convert(sd, use_bn)
        except ValueError as e:
            raise SystemExit(f"{name}: {ckpt}: {e}") from e
        meta: dict = {"kind": name, "use_bn": use_bn}
        if cfg_path:
            raw_cfg = load_reference_yaml(cfg_path)
            logging.info("%s: ingesting checkpoint config %s", name, cfg_path)
            # derive the typed config now, so that an unsupported config
            # fails at conversion rather than at the first register
            typed = (refiner_cfg_from_reference if name == "refiner" else scorer_cfg_from_reference)(raw_cfg)
            resolved = apply_reference_defaults(raw_cfg, name)
            if bool(resolved.get("use_BN")) != use_bn:
                raise SystemExit(
                    f"{name}: config says use_BN={resolved.get('use_BN')} but the checkpoint "
                    f"{'has' if use_bn else 'lacks'} BatchNorm statistics"
                )
            meta["reference_config"] = _jsonable(resolved)
            logging.info("%s cfg: %s", name, typed)
        else:
            logging.warning(
                "%s: no config.yml found next to %s: loaders will use the default configs with "
                "use_bn detected from the weights; pass --%s_config if the checkpoint shipped one",
                name, ckpt, name,
            )
        out = os.path.join(args.out_dir, f"{name}.npz")
        save_params(out, params, meta=meta)
        logging.info("%s: %s -> %s", name, ckpt, out)


def _jsonable(d: dict) -> dict:
    """inf -> "Infinity" (JSON-safe; apply_reference_defaults parses it back)."""
    return {k: ("Infinity" if isinstance(v, float) and math.isinf(v) else v) for k, v in d.items()}


if __name__ == "__main__":
    main()
