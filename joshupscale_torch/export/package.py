"""Model packages: the deployable artifact.

A package is a directory holding ``model.yaml`` (the model config and
the name of the inference entry) and ``params.npz`` (flat dotted-path
params in the reference's layouts).  Port of ``save_package`` and
``load_package`` from ``joshupscale_tpu/export/package.py``: a package
either side writes loads on the other.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from joshupscale_torch.export.weights import load_params_npz, to_flat_numpy
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.models.registry import (
    BuiltModel,
    create_models,
    load_into,
)


def save_package(path: str, model_config: Dict[str, Any], built: BuiltModel,
                 inference_name: str = "inference",
                 export_stablehlo: bool = False, batch_size: int = 1) -> None:
    """Write a package for a built inference model: ``model.yaml``
    (``model_config`` and ``inference_name``) and ``params.npz``.

    ``export_stablehlo`` asks for the reference's Python-free serving
    artifact, an XLA program (StableHLO) for its PJRT runtime; it has no
    counterpart on CUDA and raises ``NotImplementedError``.
    ``batch_size`` sized only that program.
    """
    if export_stablehlo:
        raise NotImplementedError(
            "export_stablehlo writes an XLA program (StableHLO and its "
            "compile options) for the reference's PJRT runtime; it has no "
            "counterpart on CUDA.  Serve the package with create_runtime.")
    import yaml  # only the package files need it

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.yaml"), "w") as f:
        yaml.safe_dump({"models": model_config, "inference": inference_name},
                       f)
    np.savez(os.path.join(path, "params.npz"), **to_flat_numpy(built.params))


def load_model_config(path: str) -> Dict[str, Any]:
    """The models of a YAML config file (a tier file, ``configs/*.yaml``):
    its ``models:`` entry, or the whole file where it has none."""
    import yaml  # only the package files need it

    with open(path) as f:
        doc = yaml.safe_load(f)
    return doc["models"] if "models" in doc else doc


def load_package(path: str) -> Tuple[InferenceModel, Dict[str, Any]]:
    """Load a package: returns ``(InferenceModel, params)``."""
    import yaml  # only the package files need it

    with open(os.path.join(path, "model.yaml")) as f:
        meta = yaml.safe_load(f)
    models = create_models(meta["models"], seed=0)
    built = models[meta.get("inference", "inference")]
    params = load_into(built.params,
                       load_params_npz(os.path.join(path, "params.npz")))
    return built.obj, params
