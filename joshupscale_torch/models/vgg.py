"""VGG19 feature extractor of the perceptual loss.

Port of ``joshupscale_tpu/models/vgg.py``: the input is a BGR frame in
[-0.5, 0.5]; the net rescales with ``x * 255 + 0.5``, reverses the
channels and subtracts the caffe ImageNet mean (in ``x.dtype``), then
runs the VGG19 convs (relu; a 2x2 max pool after blocks 1-4) and
returns the configured layers' activations (default block2_conv2,
block3_conv4, block4_conv4, block5_conv4).

ImageNet weights are not in the repository: pass ``weights_path`` (a
flat ``.npz`` with keys such as ``block1_conv1.kernel``, in the
reference's layouts) to load them; without it the net keeps its seeded
glorot-uniform weights -- a fixed random-feature perceptual metric, as
the reference documents.  VGG is never trained.
"""

from __future__ import annotations

import functools
import warnings
from typing import List, Optional

import numpy as np
import torch

from joshupscale_torch.nn.layers import conv2d, conv2d_init, max_pool_2x2

# VGG19 topology: (block, convs, channels).
_VGG19_CFG = [(1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512),
              (5, 4, 512)]

DEFAULT_OUT_LAYERS = ["block2_conv2", "block3_conv4", "block4_conv4",
                      "block5_conv4"]

_CAFFE_MEAN = (103.939, 116.779, 123.68)


@functools.cache
def _caffe_mean(dtype: torch.dtype, device) -> torch.Tensor:
    """The caffe mean on a device, made once (a step copies nothing from
    the host)."""
    return torch.tensor(_CAFFE_MEAN, dtype=dtype, device=device)


def vgg19_init(rng: np.random.Generator):
    params = {}
    in_ch = 3
    for block, n_convs, ch in _VGG19_CFG:
        for i in range(1, n_convs + 1):
            params[f"block{block}_conv{i}"] = conv2d_init(rng, 3, in_ch, ch,
                                                          use_bias=True)
            in_ch = ch
    return params


def vgg19_apply(params, x: torch.Tensor,
                out_layers: Optional[List[str]] = None
                ) -> List[torch.Tensor]:
    """x: (N, H, W, 3) BGR in [-0.5, 0.5] -> the ``out_layers``'
    activations, in ``x.dtype``."""
    out_layers = out_layers or DEFAULT_OUT_LAYERS
    out = x * 255.0 + 0.5
    out = torch.flip(out, dims=(-1,)) - _caffe_mean(x.dtype, x.device)
    outputs = {}
    for block, n_convs, _ in _VGG19_CFG:
        for i in range(1, n_convs + 1):
            name = f"block{block}_conv{i}"
            out = torch.relu(conv2d(params[name], out))
            if name in out_layers:
                outputs[name] = out
        if block < 5:
            out = max_pool_2x2(out)
    return [outputs[name] for name in out_layers]


def build_vgg(rng: np.random.Generator, out_layers=None,
              weights_path: Optional[str] = None):
    """``(params, apply)``: seeded random weights, or ``weights_path``'s
    (loaded through ``export/weights.load_params_npz``, checked against
    the net's shapes)."""
    params = vgg19_init(rng)
    if weights_path is not None:
        from joshupscale_torch.export.weights import load_params_npz
        from joshupscale_torch.models.registry import load_into

        params = load_into(params, load_params_npz(weights_path))
    else:
        warnings.warn(
            "VGG19 built with random weights (no imagenet weights "
            "available); perceptual loss uses fixed random features.")
    layers = list(out_layers) if out_layers else list(DEFAULT_OUT_LAYERS)

    def apply(p, x, **_):
        return vgg19_apply(p, x, out_layers=layers)

    return params, apply
