"""Recalibrate the batch-norm moving statistics of a trained checkpoint.

Port of ``tools/bn_recalibrate.py``.  It runs the FRVSR training forward
(``training=True``: the flow net batched, the generator's recurrence,
the serving activation distribution) over ``--batches`` batches of the
config's ``train_dataset``, derives from each BN update the batch
statistic it implies (``upd = old * m + batch * (1 - m)``, so ``batch =
(upd - old * m) / (1 - m)``) and sets each moving statistic to their
mean: the momentum EMA run to convergence, in one pass.

FRVSR checkpoints (``params.*``) and GAN ones (``gen_params.*``) are
taken; only ``moving_mean`` / ``moving_variance`` leaves change.  The
recurrence's first frame warps noise (``draw_noise``), drawn from a
``torch.Generator`` seeded 0.

    python -m joshupscale_torch.tools.bn_recalibrate \\
        checkpoints/frvsr_learn10/best.npz -c configs/frvsr_synth_learn.yaml \\
        [-o best_bncal.npz] [--batches 32] [--batch-size 4] [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Iterable

import numpy as np
import torch

STATS = ("moving_mean", "moving_variance")


def frvsr_models(config: dict):
    """The config's models with an ``frvsr`` trainer entry (added over
    ``flow`` / ``generator`` where the config has none, as for a GAN
    config) and without ``weights:`` bootstraps (the checkpoint is
    loaded instead)."""
    models = {k: dict(v) if isinstance(v, dict) else v
              for k, v in config["models"].items()}
    models.setdefault("frvsr", {"name": "frvsr", "flow": {"model": "flow"},
                                "generator": {"model": "generator"}})
    for v in models.values():
        if isinstance(v, dict):
            v.pop("weights", None)
    return models


def implied_batch_stats(trainer, params, batches: Iterable[Dict],
                        noise: Callable, device,
                        log: Callable = lambda i: None):
    """``{bn path: {stat: [batch statistic, ...]}}`` (float64 numpy) of
    the FRVSR training forward over ``batches`` (host batches, u8 or
    normalized); ``noise(i, input_shape)`` gives batch i's noise
    (``FRVSRTrainer.draw_noise``'s form)."""
    from joshupscale_torch.nn.layers import BN_MOMENTUM
    from joshupscale_torch.training.trainer import device_normalize

    acc = {}
    for i, host in enumerate(batches):
        batch = device_normalize(host, device)
        with torch.no_grad():
            upd = trainer.forward(
                params, batch["input"], batch["target"],
                {k: v.to(device) for k, v in noise(
                    i, tuple(batch["input"].shape)).items()},
                training=True)["bn_updates"]
        for path, stats in upd.items():
            if "moving_mean" not in stats:
                continue  # fade-in counters
            node = params
            for part in path.split("."):
                node = node[part]
            for stat in STATS:
                old = node[stat].double().cpu().numpy()
                new = stats[stat].double().cpu().numpy()
                acc.setdefault(path, {}).setdefault(stat, []).append(
                    (new - old * BN_MOMENTUM) / (1.0 - BN_MOMENTUM))
        log(i)
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-o", "--out", default=None,
                    help="output npz (default: <input>_bncal.npz)")
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    from joshupscale_torch import resolve_device
    from joshupscale_torch.data.pipeline import create_train_dataset
    from joshupscale_torch.export.importer import unflatten_into
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.training.cli import load_config
    from joshupscale_torch.training.trainer import to_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = load_config(args.config)
    built = create_models(frvsr_models(cfg), seed=0)["frvsr"]
    trainer = built.obj

    with np.load(args.checkpoint) as data:
        flat = {k: data[k] for k in data.files}
    prefix = ("gen_params." if any(k.startswith("gen_params.") for k in flat)
              else "params.")
    sub = {k[len(prefix):]: v for k, v in flat.items()
           if k.startswith(prefix)}
    params = to_device(unflatten_into(built.params, sub), device)

    it = iter(create_train_dataset(cfg["train_dataset"], args.batch_size))
    gen = torch.Generator(device).manual_seed(0)
    acc = implied_batch_stats(
        trainer, params, (next(it) for _ in range(args.batches)),
        lambda i, shape: trainer.draw_noise(shape, gen, device), device,
        lambda i: print(f"\rbatch {i + 1}/{args.batches}", end="",
                        flush=True))
    print()

    n_set = 0
    for path, stats in acc.items():
        for stat, vals in stats.items():
            key = f"{prefix}{path}.{stat}"
            if key not in flat:
                raise SystemExit(f"checkpoint missing {key}")
            flat[key] = np.mean(vals, axis=0).astype(flat[key].dtype)
            n_set += 1
    out = args.out or args.checkpoint.replace(".npz", "_bncal.npz")
    np.savez(out, **flat)
    print(f"recalibrated {n_set} moving-stat arrays ({len(acc)} BN layers) "
          f"-> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
