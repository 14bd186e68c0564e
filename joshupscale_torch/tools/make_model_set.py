"""Lay out the four-package OBS data directory from the tier configs.

Port of ``tools/make_model_set.py``.  The OBS plugin loads four models
by name from its module data directory (``native/plugins/obs/filter.cc``
``kModels``) plus the PS2 HUD mask:

    <out>/
      model_psp/        <- configs/inference_quality.yaml
      model_psp_fast/   <- configs/inference_fast.yaml
      model_ps2/        <- configs/inference_ps2_style.yaml
      model_ps2_fast/   <- configs/inference_ps2_fast.yaml
      mask.png          <- native/plugins/obs/data/mask.png

Each package is ``model.yaml`` + ``params.npz`` (``export.package``),
from ``create_models`` with random weights or a tier's ``--weights``
checkpoint (any layout ``fit`` writes; the prefix is detected).  The
reference's packages can also carry a StableHLO program for its PJRT
runtime; the port cannot write one, so ``--no-stablehlo`` is accepted
and changes nothing.

    python -m joshupscale_torch.tools.make_model_set --out dist/data \\
        [--models model_psp ...] [--config model_psp=tiny.yaml] \\
        [--weights model_psp=checkpoints/gan/best.npz] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MODEL_CONFIGS = {
    "model_psp": "configs/inference_quality.yaml",
    "model_psp_fast": "configs/inference_fast.yaml",
    "model_ps2": "configs/inference_ps2_style.yaml",
    "model_ps2_fast": "configs/inference_ps2_fast.yaml",
}

MASK = os.path.join(REPO, "native", "plugins", "obs", "data", "mask.png")


def _parse_overrides(pairs, what):
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--{what} wants model=path, got: {pair}")
        name, path = pair.split("=", 1)
        if name not in MODEL_CONFIGS:
            raise SystemExit(
                f"unknown model {name!r}; one of {sorted(MODEL_CONFIGS)}")
        out[name] = path
    return out


def build_model_set(out, models=None, configs=None, weights=None, seed=0):
    """Write the requested packages (default: all four) and the mask into
    ``out``; returns the package directories written."""
    from joshupscale_torch.export.importer import detect_checkpoint_prefix
    from joshupscale_torch.export.package import (
        load_model_config,
        save_package,
    )
    from joshupscale_torch.models.registry import create_models

    configs = configs or {}
    weights = weights or {}
    os.makedirs(out, exist_ok=True)
    written = []
    for name in models or sorted(MODEL_CONFIGS):
        cfg_path = configs.get(name, os.path.join(REPO,
                                                  MODEL_CONFIGS[name]))
        config = load_model_config(cfg_path)
        if name in weights:
            # fit() checkpoints are whole train states (``params.`` or
            # ``gen_params.``); a raw params npz has no prefix.
            prefix = detect_checkpoint_prefix(weights[name])
            entry = dict(config["inference"])
            entry["weights"] = ({"path": weights[name], "prefix": prefix}
                                if prefix else weights[name])
            config = dict(config, inference=entry)
        print(f"[{name}] building from {cfg_path}"
              + (f" + weights {weights[name]}" if name in weights
                 else " (random init)"), flush=True)
        built = create_models(config, seed=seed)["inference"]
        path = os.path.join(out, name)
        save_package(path, config, built)
        written.append(path)
    if os.path.exists(MASK):
        shutil.copyfile(MASK, os.path.join(out, "mask.png"))
    else:
        print("warning: HUD mask missing, layout is PS2-incomplete",
              file=sys.stderr)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="module data dir to create")
    ap.add_argument("--models", nargs="*", choices=sorted(MODEL_CONFIGS),
                    help="subset to build (default: all four)")
    ap.add_argument("--config", action="append", metavar="MODEL=YAML",
                    help="override a tier's config file")
    ap.add_argument("--weights", action="append", metavar="MODEL=NPZ",
                    help="checkpoint for a tier (default random init)")
    ap.add_argument("--no-stablehlo", action="store_true",
                    help="accepted for the reference tool's sake: the "
                         "port's packages carry no StableHLO program")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="accepted for the reference tool's sake: writing "
                         "packages needs no device")
    args = ap.parse_args(argv)

    written = build_model_set(
        args.out, models=args.models,
        configs=_parse_overrides(args.config, "config"),
        weights=_parse_overrides(args.weights, "weights"), seed=args.seed)
    print(f"wrote {len(written)} package(s) under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
