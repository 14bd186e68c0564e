"""Config-driven model registry.

Port of ``create_models`` from ``joshupscale_tpu/models/registry.py`` for
the factories ``flow-resnet``, ``flow-autoencoder``, ``generator-resnet``,
``inference`` and the FRVSR trainers ``frvsr`` and ``frvsr-single``.
Entries name a factory; values of the form ``{"model": <name>}``
cross-reference other entries; ``weights`` loads a flat ``.npz``
(optionally a dotted ``prefix`` subtree of it); ``freeze`` (true, or a
list of dotted paths) marks params the trainers must not move.
Initialization is seeded numpy glorot-uniform: the port's own random
values, not the reference's -- carry weights across with
``export/weights.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from joshupscale_torch.models import fnet, generator
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.ops.temporal import FrameMovingAvgConfig


@dataclasses.dataclass
class BuiltModel:
    """A constructed model: params + bound apply + metadata."""

    kind: str
    params: Any
    apply: Optional[Callable[..., Any]] = None
    obj: Any = None
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Raw params -> serving params (a net's ``prepare_*``), where the
    # net has one.
    prepare: Optional[Callable[..., Any]] = None
    # The net's training form on raw params (``*_train``).
    train_apply: Optional[Callable[..., Any]] = None
    trainable: bool = True
    frozen_paths: tuple = ()


def _sub_frozen(prefix: str, sub: Optional[BuiltModel]) -> tuple:
    """A sub-model's freeze markers re-rooted under ``prefix``, so that
    ``freeze`` on a sub-model's entry reaches its trainer's mask."""
    if sub is None:
        return ()
    if not sub.trainable:
        return (prefix,)
    return tuple(f"{prefix}.{p}" for p in sub.frozen_paths)


DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _build_flow_resnet(rng, *, num_inputs=4, num_filters=64,
                       num_res_blocks=10, activation="relu",
                       zero_init_tail=False, **_):
    params = fnet.flow_resnet_init(
        rng, num_inputs=num_inputs, num_filters=num_filters,
        num_res_blocks=num_res_blocks, zero_init_tail=zero_init_tail)
    apply = functools.partial(fnet.flow_resnet_apply, activation=activation,
                              num_res_blocks=num_res_blocks)
    train_apply = functools.partial(
        fnet.flow_resnet_train, activation=activation,
        num_res_blocks=num_res_blocks)
    return BuiltModel(kind="flow-resnet", params=params, apply=apply,
                      config={"num_inputs": num_inputs},
                      prepare=fnet.prepare_flow_resnet,
                      train_apply=train_apply)


def _build_flow_autoencoder(rng, *, num_inputs=4, filters=None,
                            activation="relu", **_):
    params = fnet.flow_autoencoder_init(rng, num_inputs=num_inputs,
                                        filters=filters)
    # The apply reads the ladder from the param tree.
    apply = functools.partial(fnet.flow_autoencoder_apply,
                              activation=activation)
    return BuiltModel(kind="flow-autoencoder", params=params, apply=apply,
                      config={"num_inputs": num_inputs},
                      prepare=fnet.prepare_flow_autoencoder,
                      train_apply=functools.partial(
                          fnet.flow_autoencoder_train,
                          activation=activation))


def _build_generator_resnet(rng, *, num_filters=64, num_res_blocks=24,
                            num_fade_in_res_blocks=0, fade_in_period=0,
                            activation="relu", zero_init_tail=False, **_):
    params = generator.generator_resnet_init(
        rng, num_filters=num_filters, num_res_blocks=num_res_blocks,
        num_fade_in_res_blocks=num_fade_in_res_blocks,
        fade_in_period=fade_in_period, zero_init_tail=zero_init_tail)
    apply = functools.partial(generator.generator_resnet_apply,
                              activation=activation)
    return BuiltModel(kind="generator-resnet", params=params, apply=apply,
                      train_apply=functools.partial(
                          generator.generator_resnet_train,
                          activation=activation))


def _build_inference(rng, *, generator_model: BuiltModel,
                     flow_model: Optional[BuiltModel] = None,
                     skip_processing=True, frame_height=None,
                     frame_width=None, compute_dtype=torch.float32,
                     s2d_mode=True, deferred_display=True,
                     flow_pad_factor=None, normalize_brightness=False,
                     frame_moving_avg=None, output_flow=False,
                     remove_flow=False, u8_state=False, **_):
    if frame_moving_avg is not None and not isinstance(
            frame_moving_avg, FrameMovingAvgConfig):
        frame_moving_avg = FrameMovingAvgConfig(**frame_moving_avg)
    if flow_model is None and not remove_flow:
        raise ValueError("inference needs a flow model unless remove_flow")
    use_flow = flow_model is not None and not remove_flow
    model = InferenceModel(
        flow_apply=flow_model.apply if use_flow else None,
        generator_apply=generator_model.apply,
        num_flow_frames=(flow_model.config.get("num_inputs", 4)
                         if use_flow else 0),
        frame_height=frame_height or 270,
        frame_width=frame_width or 480,
        skip_processing=skip_processing,
        compute_dtype=compute_dtype,
        s2d_mode=s2d_mode,
        deferred_display=deferred_display,
        flow_pad_factor=flow_pad_factor,
        normalize_brightness=normalize_brightness,
        frame_moving_avg=frame_moving_avg,
        output_flow=output_flow,
        remove_flow=remove_flow,
        u8_state=u8_state,
        flow_prepare=(flow_model.prepare if use_flow
                      else fnet.prepare_flow_resnet),
        flow_train=flow_model.train_apply if use_flow else None,
        generator_train=generator_model.train_apply,
    )
    params = {"generator": generator_model.params}
    if flow_model is not None:
        params["flow"] = flow_model.params
    return BuiltModel(kind="inference", params=params, obj=model,
                      apply=model.apply,
                      frozen_paths=(_sub_frozen("flow", flow_model)
                                    + _sub_frozen("generator",
                                                  generator_model)))


def _build_frvsr(rng, *, flow_model: BuiltModel,
                 generator_model: BuiltModel,
                 inference_model: Optional[BuiltModel] = None,
                 learning_rate=0.0005, normalize_brightness=False,
                 regularization=None, compute_dtype=torch.float32,
                 s2d_train_warp=False, s2d_scan_warp=True, **_):
    """FRVSR trainer over a flow net and a generator."""
    from joshupscale_torch.training.frvsr import FRVSRTrainer

    trainer = FRVSRTrainer(
        flow_apply=flow_model.train_apply,
        generator_apply=generator_model.train_apply,
        num_flow_frames=flow_model.config.get("num_inputs", 4),
        normalize_brightness=normalize_brightness,
        compute_dtype=compute_dtype,
        s2d_train_warp=s2d_train_warp,
        s2d_scan_warp=s2d_scan_warp,
    )
    params = {"flow": flow_model.params,
              "generator": generator_model.params}
    return BuiltModel(
        kind="frvsr", params=params, obj=trainer,
        frozen_paths=(_sub_frozen("flow", flow_model)
                      + _sub_frozen("generator", generator_model)),
        config={"learning_rate": learning_rate,
                "regularization": regularization,
                "inference": inference_model})


def _build_frvsr_single(rng, *, inference_model: BuiltModel,
                        learning_rate=0.0005, regularization=None, **_):
    """Single-step FRVSR trainer over an inference model, which it runs
    as a pixel-state twin (the trainer feeds HR state by hand)."""
    from joshupscale_torch.training.frvsr import FRVSRSingleTrainer

    model = dataclasses.replace(inference_model.obj, s2d_mode=False)
    return BuiltModel(
        kind="frvsr-single", params=inference_model.params,
        obj=FRVSRSingleTrainer(model=model),
        trainable=inference_model.trainable,
        frozen_paths=inference_model.frozen_paths,
        config={"learning_rate": learning_rate,
                "regularization": regularization,
                "inference": inference_model})


MODELS: Dict[str, Callable[..., BuiltModel]] = {
    "flow-resnet": _build_flow_resnet,
    "flow-autoencoder": _build_flow_autoencoder,
    "generator-resnet": _build_generator_resnet,
    "inference": _build_inference,
    "frvsr": _build_frvsr,
    "frvsr-single": _build_frvsr_single,
}

# Factories of the reference that a later slice brings.
_GAN_SLICE = "the GAN training slice (ROADMAP 14b)"
_LATER_MODELS = {"discriminator": _GAN_SLICE, "vgg": _GAN_SLICE,
                 "gan": _GAN_SLICE}


def _check_same_structure(template, loaded, path=""):
    """Raise unless ``loaded`` has ``template``'s keys and shapes."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"expected a subtree at {path or '<root>'}")
        missing = set(template) - set(loaded)
        extra = set(loaded) - set(template)
        if missing or extra:
            raise KeyError(f"parameter mismatch at {path or '<root>'}: "
                           f"missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        for k in template:
            _check_same_structure(template[k], loaded[k],
                                  f"{path}.{k}" if path else k)
    elif tuple(template.shape) != tuple(loaded.shape):
        raise ValueError(f"Shape mismatch for {path}: checkpoint "
                         f"{tuple(loaded.shape)} vs model "
                         f"{tuple(template.shape)}")


def load_into(template, loaded):
    """``loaded`` checked against ``template`` and cast to its dtypes.

    Int8 params (``kernel_q`` where the template has ``kernel``) do not
    match a model's float template and raise ``KeyError``, as the
    reference's ``unflatten_into`` does: quantize after loading."""
    _check_same_structure(template, loaded)

    def cast(t, v):
        if isinstance(t, dict):
            return {k: cast(t[k], v[k]) for k in t}
        return v.to(t.dtype)

    return cast(template, loaded)


def create_models(config: Dict[str, Any],
                  seed: int = 0) -> Dict[str, BuiltModel]:
    """Build all models in a config dict, resolving cross-references."""
    from joshupscale_torch.export.weights import load_params_npz

    models: Dict[str, BuiltModel] = {}
    seeds = {name: i for i, name in enumerate(config)}

    def build(name: str) -> BuiltModel:
        if name in models:
            return models[name]
        args = dict(config[name])
        model_type = args.pop("name")
        weights = args.pop("weights", None)
        freeze = args.pop("freeze", None)
        for meta in ("copy_weights", "copy_variables"):
            if args.pop(meta, None) is not None:
                raise NotImplementedError(
                    f"{meta} is not ported yet; it waits for "
                    f"{_GAN_SLICE}")
        if isinstance(args.get("compute_dtype"), str):
            args["compute_dtype"] = DTYPES[args["compute_dtype"]]
        for arg, val in list(args.items()):
            if isinstance(val, dict) and "model" in val:
                args[arg + "_model"] = build(val["model"])
                del args[arg]
        if model_type in _LATER_MODELS:
            raise NotImplementedError(
                f"model type {model_type} is not ported yet; it waits for "
                f"{_LATER_MODELS[model_type]}")
        if model_type not in MODELS:
            raise ValueError(f"Unknown model type {model_type}")
        rng = np.random.default_rng([seed, seeds[name]])
        model = MODELS[model_type](rng, **args)
        if isinstance(freeze, list):
            # Merged with the sub-models' freezes the factory composed.
            model.frozen_paths = tuple(model.frozen_paths) + tuple(freeze)
        elif freeze is not None:
            model.trainable = not freeze
        if weights is not None:
            if isinstance(weights, dict):
                loaded = load_params_npz(weights["path"],
                                         prefix=weights.get("prefix", ""))
            else:
                loaded = load_params_npz(weights)
            model.params = load_into(model.params, loaded)
        models[name] = model
        return model

    for name in config:
        build(name)
    return models
