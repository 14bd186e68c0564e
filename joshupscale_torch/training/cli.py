"""Training CLI: YAML config -> models -> datasets -> fit -> export.

Port of ``joshupscale_tpu/training/cli.py`` for the FRVSR trainers
(``frvsr``, ``frvsr-single``) and the TecoGAN trainer (``gan``).  The
config has ``models:`` (registry entries), ``train_dataset:`` /
``val_dataset:`` (op chains), ``train:`` (loop settings) and
``export:`` (the package to write).

``build_training`` makes the models, the optimizers (two for the GAN,
each with its freeze mask), the step, the state and the validation
function; ``train`` adds the datasets, the play callback (GIF strips of
the inference entry on the play clips, when the trainer names one and a
validation set is given), the fit loop and the export: ``weights.npz``,
a serving package and, under ``export.onnx`` (``onnx_fp16``), the
deployment graph ``model.onnx`` (``model_fp16.onnx``).
``train.data_workers`` > 0 runs the data pipeline in that many worker
processes (``data/mploader.py``).  Runs on the CUDA device unless
``--cpu``.  With TensorBoard on, ``train.profile`` (default true)
traces global steps 5..10 into ``<log_dir>/profile``, beside
``<log_dir>/tb``, as the reference does (``fit``'s profiler window).

``--num-devices N`` trains data-parallel on N ranks (``parallel.mesh``:
one process per device, the global batch ``train.batch_size`` split
between them, the step the one-process step on the global batch); the
default is every visible CUDA device, as the reference's mesh spans
every device, and 1 with ``--cpu``.  ``--cpu --num-devices N`` runs N
ranks on the CPU (gloo).  Rank 0 writes the checkpoints, the logs, the
play strips and the export.

Usage: ``python -m joshupscale_torch.training.cli -c config.yaml [--cpu]
[--num-devices N]``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from joshupscale_torch import resolve_device
from joshupscale_torch.export.package import save_package
from joshupscale_torch.export.weights import to_flat_numpy
from joshupscale_torch.models.registry import BuiltModel, create_models
from joshupscale_torch.parallel.mesh import launch, mesh_devices, replicate
from joshupscale_torch.training.play import PLAY_FRAMES, PlayCallback
from joshupscale_torch.training.trainer import (
    Adam,
    TensorBoardLogger,
    build_frvsr_step,
    build_gan_step,
    fit,
    freeze_mask,
    init_gan_state,
    init_train_state,
    load_checkpoint,
    make_optimizer,
    step_noise,
    to_device,
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
                        help="data-parallel ranks (default: every CUDA "
                             "device; 1 with --cpu)")
    return parser.parse_args(argv)


def load_config(path: str) -> Dict[str, Any]:
    """A training config file (``models``, the datasets, ``train``,
    ``export``) as a dict."""
    import yaml  # only the CLI reads YAML

    with open(path) as f:
        return yaml.safe_load(f)


def main(argv=None) -> int:
    args = parse_args(argv)
    config = load_config(args.config)
    return train(config, seed=args.seed, num_devices=args.num_devices,
                 device="cpu" if args.cpu else None)


_TRAINERS = ("frvsr", "frvsr-single", "gan")


@dataclasses.dataclass
class TrainingSetup:
    """What ``train`` runs: the built models, the trainer entry, its
    optimizer (the generator group's for the GAN, with
    ``discr_optimizer``), step and fresh state (``TrainState`` or
    ``GANTrainState``), and the validation function."""

    models: Dict[str, BuiltModel]
    built: BuiltModel
    optimizer: Adam
    step: Callable
    state: Any
    val_fn: Callable
    monitor: str
    device: torch.device
    discr_optimizer: Optional[Adam] = None


def _mask(params, frozen_paths, trainable):
    """``freeze_mask`` where something is frozen, else None."""
    if frozen_paths or not trainable:
        return freeze_mask(params, tuple(frozen_paths), trainable=trainable)
    return None


def build_training(config: Dict[str, Any], seed: int = 0,
                   device=None, mesh=None) -> TrainingSetup:
    """Models, optimizer(s), step, state and ``val_fn`` for a config's
    trainer entry (``train.model``, or the one trainer).  With ``mesh``
    (inside a rank), on the rank's device: the step is the mesh's, the
    state rank 0's (``replicate``) and ``val_fn`` draws the global
    batch's noise."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    train_cfg = dict(config.get("train", {}))
    models = create_models(config["models"], seed=seed)
    name = train_cfg.get("model")
    if name is None:
        candidates = [n for n, m in models.items() if m.kind in _TRAINERS]
        if len(candidates) != 1:
            raise ValueError(f"Set train.model; trainer candidates: "
                             f"{candidates}")
        name = candidates[0]
    built = models[name]
    if built.kind not in _TRAINERS:
        raise ValueError(f"{name} is a {built.kind}, not a trainer")
    trainer = built.obj
    reg = built.config.get("regularization")
    l2_reg = (float(reg.get("l2", 0.0))
              if isinstance(reg, dict) and reg.get("name") == "l2" else 0.0)
    lr = built.config.get("learning_rate", 0.0005)
    spe = int(train_cfg.get("steps_per_execution", 1))
    optimizer = make_optimizer(lr)
    discr_optimizer = None

    if built.kind == "gan":
        # Both freeze forms: dotted paths (sub-model freezes composed by
        # the registry) and ``freeze: true`` on the trainer entry.
        discr_optimizer = make_optimizer(lr)
        gen_mask = _mask(built.params["gen"], built.frozen_paths,
                         built.trainable)
        discr_mask = _mask(
            built.params["discr"],
            built.config.get("discr_frozen_paths", ()),
            built.trainable and built.config.get("discr_trainable", True))
        vgg_params = to_device(built.params["vgg"], dev)
        step = build_gan_step(trainer, optimizer, discr_optimizer,
                              vgg_params, gen_mask=gen_mask,
                              discr_mask=discr_mask, l2_reg=l2_reg,
                              mesh=mesh, steps_per_execution=spe)
        state = init_gan_state(trainer, built.params["gen"],
                               built.params["discr"], optimizer,
                               discr_optimizer, dev)

        def val_fn(st, batch, rng: torch.Generator):
            # Inference batch norm (the reference's test_step).
            with torch.no_grad():
                noise = step_noise(trainer, mesh, batch["input"].shape,
                                   rng, dev)
                y = trainer.forward(st.gen_params, st.discr_params,
                                    vgg_params,
                                    batch["input"], batch["target"], noise,
                                    training=False)
                terms = trainer.compute_losses(y, st.ema)
            return {k: v for k, v in terms.items()
                    if k not in ("gen_loss", "discr_loss")}

        monitor = train_cfg.get("monitor", "content_loss")
    else:
        step = build_frvsr_step(
            trainer, optimizer,
            mask=_mask(built.params, built.frozen_paths, built.trainable),
            l2_reg=l2_reg, mesh=mesh, steps_per_execution=spe)
        state = init_train_state(built.params, optimizer, dev)

        def val_fn(st, batch, rng: torch.Generator):
            # Inference batch norm (the reference's test_step).
            with torch.no_grad():
                noise = step_noise(trainer, mesh, batch["input"].shape,
                                   rng, dev)
                _, aux = trainer.loss(st.params, batch, noise,
                                      training=False)
            return aux["metrics"]

        monitor = train_cfg.get("monitor", "loss")

    if mesh is not None:
        state = type(state)(**replicate(mesh, state.tree()))
    return TrainingSetup(models=models, built=built, optimizer=optimizer,
                         step=step, state=state, val_fn=val_fn,
                         monitor=monitor, device=dev,
                         discr_optimizer=discr_optimizer)


def train(config: Dict[str, Any], seed: int = 0, num_devices=None,
          device=None) -> int:
    """Build, fit on the config's datasets, export; returns 0.

    ``num_devices`` ranks train data-parallel: CUDA devices 0..N-1 (more
    than exist raises), or N CPU ranks for ``device="cpu"``.  The
    default is every visible CUDA device where ``device`` is None (the
    CLI without ``--cpu``), else 1 on ``device``."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    n = num_devices
    if n is None:
        n = max(torch.cuda.device_count(), 1) if device is None else 1
    if n == 1:
        return _train(config, seed, device)
    devices = ["cpu"] * n if on_cpu else mesh_devices(n)
    print(f"data-parallel mesh over {n} devices")
    return launch(_train_rank, n, config, seed, devices=devices)


def _train_rank(mesh, config: Dict[str, Any], seed: int) -> int:
    return _train(config, seed, mesh.device, mesh)


def _train(config: Dict[str, Any], seed: int, device, mesh=None) -> int:
    """``train`` in one process, or in one rank of ``mesh``."""
    from joshupscale_torch.data import (
        create_train_dataset,
        create_val_dataset,
    )

    lead = mesh is None or mesh.rank == 0
    setup = build_training(config, seed, device, mesh)
    train_cfg = dict(config.get("train", {}))
    batch_size = int(train_cfg.get("batch_size", 4))
    ckpt_dir = train_cfg.get("checkpoint_dir", "checkpoints")
    log_dir = train_cfg.get("log_dir", ckpt_dir)

    train_ds = create_train_dataset(
        config["train_dataset"], batch_size, seed=seed,
        num_workers=int(train_cfg.get("data_workers", 0)))
    tb_dir = (os.path.join(log_dir, "tb")
              if train_cfg.get("tensorboard", True) else None)
    val_ds = play_cb = None
    if "val_dataset" in config:
        val_ds, play_ds = create_val_dataset(
            config["val_dataset"], batch_size,
            play_size=int(train_cfg.get("play_size", 4)),
            val_size=int(train_cfg.get("val_size", 16)), seed=seed)
        if next(iter(val_ds), None) is None and lead:
            print("WARNING: val dataset yielded no full batches "
                  "(val_size/batch_size exceed the available "
                  "sequences?); validation metrics will be absent")
        inference = setup.built.config.get("inference")
        if lead and inference is not None and inference.obj is not None:
            play_batch = next(iter(play_ds), None)
            if play_batch is None:
                raise ValueError(
                    "play dataset is empty: the val dataset must yield at "
                    "least play_size sequences (BatchOp drops incomplete "
                    "batches)")
            frames = np.asarray(play_batch["input"]).shape[1]
            if frames < PLAY_FRAMES:
                print(f"play callback off: the play clips have {frames} "
                      f"frames, the playback takes {PLAY_FRAMES}")
            else:
                play_cb = PlayCallback(
                    inference.obj, play_batch,
                    os.path.join(log_dir, "play"),
                    interval=int(train_cfg.get("play_interval", 1)),
                    tb_logger=TensorBoardLogger(tb_dir) if tb_dir else None,
                    device=setup.device)

    state = setup.state
    resume = train_cfg.get("resume")
    if resume:
        state = type(state)(**load_checkpoint(resume, state.tree()))
        if lead:
            print(f"resumed from {resume}")

    # Closed after the fit: a multiprocess loader's workers stop and
    # their shared-memory segments are unlinked.
    train_iter = iter(train_ds)
    try:
        state, _ = fit(
            setup.step, state, train_iter,
            epochs=int(train_cfg.get("epochs", 1)),
            steps_per_epoch=int(train_cfg.get("steps_per_epoch", 100)),
            rng=torch.Generator(setup.device).manual_seed(seed),
            val_fn=setup.val_fn if val_ds is not None else None,
            val_data=val_ds, cache_val_on_device=True,
            checkpoint_dir=ckpt_dir, monitor=setup.monitor,
            early_stopping_patience=train_cfg.get("early_stopping_patience"),
            epoch_callback=play_cb, tensorboard_dir=tb_dir,
            profile_dir=(os.path.join(log_dir, "profile")
                         if tb_dir and train_cfg.get("profile", True)
                         else None),
            metric_lag=train_cfg.get("metric_lag"),
            stage_inputs=bool(train_cfg.get("stage_inputs", True)))
    finally:
        train_iter.close()

    export_cfg = config.get("export")
    if export_cfg and lead:
        _export(export_cfg, config, setup.models, setup.built, state)
    return 0


def _export(export_cfg, config, models, built: BuiltModel, state) -> None:
    """Write the trained weights (``weights.npz``) and a serving package
    of the inference entry carrying them (``package/``): the config cut
    to what the inference entry reaches, with ``skip_processing:
    false`` (the runtime feeds u8 frames) and ``export.overrides``
    merged into its entry.  ``export.onnx`` also writes the package's
    model as the reference's deployment graph (``model.onnx``; with
    ``onnx_fp16``, ``model_fp16.onnx`` too), with the model's options;
    an architecture the exporter does not take (``_onnx_unsupported``)
    is skipped, printed."""
    out_dir = export_cfg.get("dir", "export")
    os.makedirs(out_dir, exist_ok=True)
    trained = state.gen_params if built.kind == "gan" else state.params
    np.savez(os.path.join(out_dir, "weights.npz"), **to_flat_numpy(trained))

    inference = built.config.get("inference")
    inf_name = export_cfg.get("model")
    if inf_name and inf_name in models:
        inference = models[inf_name]
    if inference is None or inference.obj is None:
        return
    if built.kind in ("frvsr", "gan"):
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
    if export_cfg.get("onnx"):
        _export_onnx(out_dir, rebuilt, bool(export_cfg.get("onnx_fp16")),
                     _onnx_unsupported(model_cfg, inf_key))


# The model types ``export_onnx`` writes a graph for, by role in an
# ``inference`` entry.
_ONNX_ARCH = {"flow": ("flow-resnet", "flow-autoencoder"),
              "generator": ("generator-resnet",)}


def _onnx_unsupported(model_cfg: Dict[str, Any],
                      inf_key: str) -> Optional[str]:
    """What of the inference entry ``model_cfg[inf_key]`` the ONNX
    exporter does not take, or None: it writes a model whose flow net
    (unless ``remove_flow``) and generator are of the types in
    ``_ONNX_ARCH``."""
    entry = model_cfg[inf_key]
    for role, kinds in _ONNX_ARCH.items():
        ref = entry.get(role)
        if not isinstance(ref, dict) or (role == "flow"
                                          and entry.get("remove_flow")):
            continue
        kind = model_cfg[ref["model"]]["name"]
        if kind not in kinds:
            return f"{role} {kind}"
    return None


def _export_onnx(out_dir: str, built: BuiltModel, fp16: bool,
                 unsupported: Optional[str]) -> None:
    """``model.onnx`` (and ``model_fp16.onnx``) of a built inference
    model, with its deployment options (the reference's exit door into
    its TensorRT toolchain, train_local.py:194-207); skipped, printed,
    for an architecture the exporter does not take (``unsupported``).
    Any error of the export itself propagates."""
    if unsupported:
        print(f"ONNX export skipped (unsupported arch): {unsupported}")
        return
    from joshupscale_torch.export.onnx_export import export_onnx

    m = built.obj
    opts = dict(num_flow_frames=m.num_flow_frames,
                frame_moving_avg=m.frame_moving_avg,
                output_flow=m.output_flow, remove_flow=m.remove_flow,
                flow_pad_factor=m.flow_pad_factor,
                normalize_brightness=m.normalize_brightness)
    for name, half in (("model.onnx", False),
                       ("model_fp16.onnx", True))[:1 + fp16]:
        path = os.path.join(out_dir, name)
        export_onnx(path, built.params, m.frame_height, m.frame_width,
                    fp16=half, **opts)
        print(f"exported {'fp16 ' if half else ''}ONNX graph to {path}")


if __name__ == "__main__":
    raise SystemExit(main())
