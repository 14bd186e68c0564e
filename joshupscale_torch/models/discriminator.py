"""Spatio-temporal discriminator of TecoGAN training.

Port of ``joshupscale_tpu/models/discriminator.py``: the input is a
27-channel stack of frame triples (the triple, the triple warped toward
its centre, the bilinearly upscaled LR triple); the outputs are the four
block activations (for the feature-matching loss) and the per-patch
logits.  Raw params in training form: batch norm as a ``Mutables``
says, float32 params cast to the activations' dtype at each conv.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from joshupscale_torch.models.common import Mutables
from joshupscale_torch.nn.layers import (
    batch_norm_init,
    conv2d,
    conv2d_init,
    dense,
    dense_init,
    get_train_activation,
)


def discriminator_init(rng: np.random.Generator, alpha: float = 1.0):
    """Params for channel widths ``int(64 * alpha)`` (conv_1, blocks 1
    and 2), ``int(128 * alpha)`` (block 3) and ``int(256 * alpha)``
    (block 4), in the reference's key order."""
    c64, c128, c256 = int(64 * alpha), int(128 * alpha), int(256 * alpha)
    params = {"conv_1": conv2d_init(rng, 3, 27, c64, use_bias=True)}
    for i, (cin, cout) in enumerate(((c64, c64), (c64, c64), (c64, c128),
                                     (c128, c256)), start=1):
        params[f"block_{i}"] = {
            "conv": conv2d_init(rng, 4, cin, cout, use_bias=False),
            "bn": batch_norm_init(cout),
        }
    params["dense"] = dense_init(rng, c256, 1)
    return params


def discriminator_apply(params, x: torch.Tensor,
                        mut: Optional[Mutables] = None,
                        activation="lrelu") -> List[torch.Tensor]:
    """``[block_1 .. block_4 features, logits]`` of a (N, H, W, 27)
    input: conv_1 3x3 (bias), then four conv 4x4 stride 2 (TF SAME) ->
    batch norm (``mut``) -> activation blocks, then ``dense`` per
    patch."""
    mut = mut or Mutables(False)
    act = get_train_activation(activation)
    outputs = []
    net = act(conv2d(params["conv_1"], x))
    for i in range(1, 5):
        name = f"block_{i}"
        net = conv2d(params[name]["conv"], net, stride=2)
        net = act(mut.bn(params[name]["bn"], f"{name}.bn", net))
        outputs.append(net)
    outputs.append(dense(params["dense"], net))
    return outputs
