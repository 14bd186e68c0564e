"""Load a model package written by the reference's ``save_package``.

A package is a directory holding ``model.yaml`` (the model config and
the name of the inference entry) and ``params.npz`` (flat dotted-path
params).  Port of ``load_package`` from
``joshupscale_tpu/export/package.py``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

from joshupscale_torch.export.weights import load_params_npz
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.models.registry import create_models, load_into


def load_package(path: str) -> Tuple[InferenceModel, Dict[str, Any]]:
    """Load a package: returns ``(InferenceModel, params)``."""
    import yaml  # only the package loader needs it

    with open(os.path.join(path, "model.yaml")) as f:
        meta = yaml.safe_load(f)
    models = create_models(meta["models"], seed=0)
    built = models[meta.get("inference", "inference")]
    params = load_into(built.params,
                       load_params_npz(os.path.join(path, "params.npz")))
    return built.obj, params
