"""Training CLI: YAML config -> models -> datasets -> fit -> export.

Port of ``joshupscale_tpu/training/cli.py`` for the FRVSR trainers
(``frvsr``, ``frvsr-single``).  The config has ``models:`` (registry
entries), ``train_dataset:`` / ``val_dataset:`` (op chains),
``train:`` (loop settings) and ``export:`` (the package to write).

``build_training`` makes the models, the optimizer, the step, the
state and the validation function; ``train`` adds the datasets, the
fit loop and the export.  Runs on the CUDA device unless ``--cpu``.
Not ported yet, each raising where a config asks for it: the GAN
trainer (ROADMAP 14b; the registry refuses it), the data-parallel mesh
(``--num-devices`` > 1, ROADMAP 14d), ``export.onnx`` (ROADMAP 15);
the reference's play callback (GAN slice) and profiler window do not
run.

Usage: ``python -m joshupscale_torch.training.cli -c config.yaml [--cpu]``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from joshupscale_torch import resolve_device
from joshupscale_torch.export.package import save_package
from joshupscale_torch.export.weights import to_flat_numpy
from joshupscale_torch.models.registry import BuiltModel, create_models
from joshupscale_torch.training.trainer import (
    Adam,
    TrainState,
    build_frvsr_step,
    fit,
    freeze_mask,
    init_train_state,
    load_checkpoint,
    make_optimizer,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train JoshUpscale (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", required=True,
                        help="YAML config path")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA device")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="data-parallel devices (1 only, for now)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import yaml  # only the CLI reads YAML

    with open(args.config) as f:
        config = yaml.safe_load(f)
    return train(config, seed=args.seed, num_devices=args.num_devices,
                 device="cpu" if args.cpu else None)


@dataclasses.dataclass
class TrainingSetup:
    """What ``train`` runs: the built models, the trainer entry, its
    optimizer, step and fresh state, and the validation function."""

    models: Dict[str, BuiltModel]
    built: BuiltModel
    optimizer: Adam
    step: Callable
    state: TrainState
    val_fn: Callable
    monitor: str
    device: torch.device


def build_training(config: Dict[str, Any], seed: int = 0,
                   device=None) -> TrainingSetup:
    """Models, optimizer, step, state and ``val_fn`` for a config's
    trainer entry (``train.model``, or the one FRVSR trainer)."""
    dev = resolve_device(device)
    train_cfg = dict(config.get("train", {}))
    models = create_models(config["models"], seed=seed)
    name = train_cfg.get("model")
    if name is None:
        candidates = [n for n, m in models.items()
                      if m.kind in ("frvsr", "frvsr-single")]
        if len(candidates) != 1:
            raise ValueError(f"Set train.model; trainer candidates: "
                             f"{candidates}")
        name = candidates[0]
    built = models[name]
    if built.kind not in ("frvsr", "frvsr-single"):
        raise ValueError(f"{name} is a {built.kind}, not a trainer")
    trainer = built.obj
    reg = built.config.get("regularization")
    l2_reg = (float(reg.get("l2", 0.0))
              if isinstance(reg, dict) and reg.get("name") == "l2" else 0.0)
    optimizer = make_optimizer(built.config.get("learning_rate", 0.0005))
    mask = (freeze_mask(built.params, tuple(built.frozen_paths),
                        trainable=built.trainable)
            if built.frozen_paths or not built.trainable else None)
    step = build_frvsr_step(
        trainer, optimizer, mask=mask, l2_reg=l2_reg,
        steps_per_execution=int(train_cfg.get("steps_per_execution", 1)))
    state = init_train_state(built.params, optimizer, dev)

    def val_fn(st: TrainState, batch, rng: torch.Generator):
        # Inference batch norm (the reference's test_step).
        with torch.no_grad():
            noise = trainer.draw_noise(batch["input"].shape, rng, dev)
            _, aux = trainer.loss(st.params, batch, noise, training=False)
        return aux["metrics"]

    return TrainingSetup(models=models, built=built, optimizer=optimizer,
                         step=step, state=state, val_fn=val_fn,
                         monitor=train_cfg.get("monitor", "loss"),
                         device=dev)


def train(config: Dict[str, Any], seed: int = 0, num_devices=None,
          device=None) -> int:
    """Build, fit on the config's datasets, export; returns 0."""
    from joshupscale_torch.data import (
        create_train_dataset,
        create_val_dataset,
    )

    if num_devices is not None and num_devices > 1:
        raise NotImplementedError(
            "--num-devices > 1 needs the data-parallel mesh, which is not "
            "ported yet (ROADMAP 14d)")
    setup = build_training(config, seed, device)
    train_cfg = dict(config.get("train", {}))
    batch_size = int(train_cfg.get("batch_size", 4))
    ckpt_dir = train_cfg.get("checkpoint_dir", "checkpoints")
    log_dir = train_cfg.get("log_dir", ckpt_dir)

    train_ds = create_train_dataset(
        config["train_dataset"], batch_size, seed=seed,
        num_workers=int(train_cfg.get("data_workers", 0)))
    val_ds = None
    if "val_dataset" in config:
        val_ds, _ = create_val_dataset(
            config["val_dataset"], batch_size,
            play_size=int(train_cfg.get("play_size", 4)),
            val_size=int(train_cfg.get("val_size", 16)), seed=seed)
        if next(iter(val_ds), None) is None:
            print("WARNING: val dataset yielded no full batches "
                  "(val_size/batch_size exceed the available "
                  "sequences?); validation metrics will be absent")

    state = setup.state
    resume = train_cfg.get("resume")
    if resume:
        state = TrainState(**load_checkpoint(resume, state.tree()))
        print(f"resumed from {resume}")

    state, _ = fit(
        setup.step, state, iter(train_ds),
        epochs=int(train_cfg.get("epochs", 1)),
        steps_per_epoch=int(train_cfg.get("steps_per_epoch", 100)),
        rng=torch.Generator(setup.device).manual_seed(seed),
        val_fn=setup.val_fn if val_ds is not None else None,
        val_data=val_ds, cache_val_on_device=True,
        checkpoint_dir=ckpt_dir, monitor=setup.monitor,
        early_stopping_patience=train_cfg.get("early_stopping_patience"),
        tensorboard_dir=(os.path.join(log_dir, "tb")
                         if train_cfg.get("tensorboard", True) else None),
        metric_lag=train_cfg.get("metric_lag"),
        stage_inputs=bool(train_cfg.get("stage_inputs", True)))

    export_cfg = config.get("export")
    if export_cfg:
        _export(export_cfg, config, setup.models, setup.built, state)
    return 0


def _export(export_cfg, config, models, built: BuiltModel,
            state: TrainState) -> None:
    """Write the trained weights (``weights.npz``) and a serving package
    of the inference entry carrying them (``package/``): the config cut
    to what the inference entry reaches, with ``skip_processing:
    false`` (the runtime feeds u8 frames) and ``export.overrides``
    merged into its entry."""
    if export_cfg.get("onnx"):
        raise NotImplementedError(
            "export.onnx is not ported yet; it waits for ROADMAP 15 (the "
            "import/export doors)")
    out_dir = export_cfg.get("dir", "export")
    os.makedirs(out_dir, exist_ok=True)
    trained = state.params
    np.savez(os.path.join(out_dir, "weights.npz"), **to_flat_numpy(trained))

    inference = built.config.get("inference")
    inf_name = export_cfg.get("model")
    if inf_name and inf_name in models:
        inference = models[inf_name]
    if inference is None or inference.obj is None:
        return
    if built.kind == "frvsr":
        trained = {"flow": trained["flow"],
                   "generator": trained["generator"]}
    inf_key = next((n for n, m in models.items() if m is inference),
                   "inference")

    def reachable(name, seen):
        if name in seen:
            return
        seen.add(name)
        for v in config["models"][name].values():
            if isinstance(v, dict) and "model" in v:
                reachable(v["model"], seen)

    keep = set()
    reachable(inf_key, keep)
    model_cfg = {n: e for n, e in config["models"].items() if n in keep}
    inf_entry = dict(model_cfg[inf_key])
    inf_entry["skip_processing"] = False
    inf_entry.update(export_cfg.get("overrides") or {})
    model_cfg[inf_key] = inf_entry
    rebuilt = create_models(model_cfg, seed=0)[inf_key]
    rebuilt.params = trained
    save_package(os.path.join(out_dir, "package"), model_cfg, rebuilt,
                 inference_name=inf_key)
    print(f"exported package to {out_dir}/package")


if __name__ == "__main__":
    raise SystemExit(main())
