"""FNet optical-flow estimator, resnet variant.

Port of ``flow_resnet_init`` / ``flow_resnet_apply`` from
``joshupscale_tpu/models/fnet.py``.  Inputs are ``num_inputs`` NHWC
frames (current first, then the previous ones, newest to oldest); the
output is the 32-channel head, depth_to_space(4)'d unless
``s2d_output``.  ``flow_resnet_apply`` takes the serving params that
``prepare_flow_resnet`` makes once from the raw ones.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from joshupscale_torch.models.common import (
    fold_conv_bn,
    prepare_res_blocks,
    res_block_init,
    res_blocks_apply,
)
from joshupscale_torch.nn.layers import (
    batch_norm_init,
    conv2d,
    conv2d_init,
    get_activation,
    require_float_kernel,
)
from joshupscale_torch.ops.space_depth import depth_to_space


def flow_resnet_init(rng: np.random.Generator, num_inputs: int = 4,
                     num_filters: int = 64, num_res_blocks: int = 10,
                     zero_init_tail: bool = False):
    params = {
        "conv_1": conv2d_init(rng, 3, num_inputs * 3, num_filters,
                              use_bias=False),
        "bn_1": batch_norm_init(num_filters),
        "conv_2": conv2d_init(rng, 1, num_filters, 32, use_bias=True),
    }
    if zero_init_tail:
        params["conv_2"] = {k: torch.zeros_like(v)
                            for k, v in params["conv_2"].items()}
    for i in range(num_res_blocks):
        params[f"block_{i + 1}"] = res_block_init(rng, num_filters)
    return params


def prepare_flow_resnet(params, dtype: torch.dtype):
    """Raw params -> serving params in ``dtype``: ``conv_1`` with
    ``bn_1`` folded in, the head cast, every res block folded."""
    require_float_kernel(params["conv_2"])
    return {**prepare_res_blocks(params, dtype),
            "conv_1": fold_conv_bn(params["conv_1"], params["bn_1"], dtype),
            "conv_2": {k: v.to(dtype) for k, v in params["conv_2"].items()}}


def flow_resnet_apply(params, frames: List[torch.Tensor], activation="relu",
                      num_res_blocks: Optional[int] = None,
                      s2d_output: bool = False) -> torch.Tensor:
    """Frames -> (N, 4H, 4W, 2) flow, or the raw (N, H, W, 32) head
    (channel ``(ry*4+rx)*2 + {y,x}``) with ``s2d_output``.  ``params``
    as ``prepare_flow_resnet`` gives them."""
    act = get_activation(activation)
    if num_res_blocks is None:
        num_res_blocks = sum(1 for k in params if k.startswith("block_"))
    out = torch.cat(frames, dim=-1)
    out = act(conv2d(params["conv_1"], out))
    out = res_blocks_apply(
        params, [f"block_{i + 1}" for i in range(num_res_blocks)], out,
        activation)
    out = conv2d(params["conv_2"], out)
    if s2d_output:
        return out
    return depth_to_space(out, 4)
