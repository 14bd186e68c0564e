"""FNet optical-flow estimators, resnet and autoencoder variants.

Port of ``flow_resnet_*`` and ``flow_autoencoder_*`` from
``joshupscale_tpu/models/fnet.py``.  Inputs are ``num_inputs`` NHWC
frames (current first, then the previous ones, newest to oldest); the
output is the 32-channel head, depth_to_space(4)'d unless
``s2d_output``.  Each ``*_apply`` takes the serving params that its
``prepare_*`` makes once from the raw ones (float or int8, see
``models/common.py``; ``path=...`` is the calibration route) and runs
its layers through ``ops`` (``models.common.WholeFrame``; row slabs
over devices with ``parallel.rows.Rows``).
``*_train`` run the raw params in training form (``Mutables``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.models.common import (
    WHOLE_FRAME,
    Mutables,
    WholeFrame,
    batch_norm_apply,
    concat,
    conv_bn_train,
    prepare_bn,
    prepare_conv,
    prepare_conv_bn,
    prepare_res_blocks,
    res_block_init,
    res_blocks_train,
)
from joshupscale_torch.nn.layers import (
    batch_norm_init,
    conv2d,
    conv2d_init,
    get_activation,
    get_train_activation,
)
from joshupscale_torch.ops.resize import upscale_bilinear
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


def prepare_flow_resnet(params, dtype: torch.dtype, path=None):
    """Raw params -> serving params in ``dtype``: ``conv_1`` with
    ``bn_1`` (folded when float), every res block, the head (``path``:
    the net's dotted path, for calibration: nothing folded)."""
    sub = (lambda k: None) if path is None else (lambda k: f"{path}.{k}")
    return {**prepare_res_blocks(params, dtype, path),
            "conv_1": prepare_conv_bn(params["conv_1"], params["bn_1"],
                                      dtype, sub("conv_1")),
            "conv_2": prepare_conv(params["conv_2"], dtype, sub("conv_2"))}


def flow_resnet_apply(params, frames: List[torch.Tensor], activation="relu",
                      num_res_blocks: Optional[int] = None,
                      s2d_output: bool = False,
                      ops: WholeFrame = WHOLE_FRAME) -> torch.Tensor:
    """Frames -> (N, 4H, 4W, 2) flow, or the raw (N, H, W, 32) head
    (channel ``(ry*4+rx)*2 + {y,x}``) with ``s2d_output``.  ``params``
    as ``prepare_flow_resnet`` gives them; ``ops``: how each layer runs
    (``models.common.WholeFrame``)."""
    act = get_activation(activation)
    if num_res_blocks is None:
        num_res_blocks = sum(1 for k in params if k.startswith("block_"))
    out = ops.map(concat, *frames)
    out = ops.record("flow.conv_1", ops.map(
        act, ops.conv_bn(params["conv_1"], out)))
    out = ops.res_blocks(
        params, [f"block_{i + 1}" for i in range(num_res_blocks)], out,
        activation, "flow")
    out = ops.record("flow.conv_2", ops.conv(params["conv_2"], out))
    if s2d_output:
        return out
    return ops.map(depth_to_space, out, 4)


def flow_resnet_train(params, frames: List[torch.Tensor], mut: Mutables,
                      activation="relu",
                      num_res_blocks: Optional[int] = None) -> torch.Tensor:
    """``flow_resnet_apply`` on raw params in training form: frames ->
    (N, 4H, 4W, 2) flow."""
    act = get_train_activation(activation)
    if num_res_blocks is None:
        num_res_blocks = sum(1 for k in params if k.startswith("block_"))
    out = act(conv_bn_train(params["conv_1"], params["bn_1"],
                            torch.cat(frames, dim=-1), mut, "bn_1"))
    out = res_blocks_train(
        params, [f"block_{i + 1}" for i in range(num_res_blocks)], out,
        activation, mut)
    return depth_to_space(conv2d(params["conv_2"], out), 4)


# ---------------------------------------------------------------------------
# Autoencoder variant

DEFAULT_AE_FILTERS = [32, 64, 128, 256, 128, 64, 32]


def _double_conv_init(rng: np.random.Generator, in_ch: int, out_ch: int):
    return {
        "conv_1": conv2d_init(rng, 3, in_ch, out_ch, use_bias=False),
        "bn_1": batch_norm_init(out_ch),
        "conv_2": conv2d_init(rng, 3, out_ch, out_ch, use_bias=False),
        "bn_2": batch_norm_init(out_ch),
    }


def flow_autoencoder_init(rng: np.random.Generator, num_inputs: int = 4,
                          filters: Optional[List[int]] = None):
    """Ladder params: ``len(filters) // 2 * 2`` double-conv blocks (half
    down, half up), a mid ``conv_1`` + ``bn_1`` for an odd filter list,
    and the 3x3 head ``conv_2`` to 32 channels with a bias."""
    filters = list(filters) if filters else list(DEFAULT_AE_FILTERS)
    n_blocks = (len(filters) // 2) * 2
    params = {}
    in_ch = num_inputs * 3
    for i in range(n_blocks):
        params[f"block_{i + 1}"] = _double_conv_init(rng, in_ch, filters[i])
        in_ch = filters[i]
    if len(filters) % 2:
        params["conv_1"] = conv2d_init(rng, 3, in_ch, filters[-1],
                                       use_bias=False)
        params["bn_1"] = batch_norm_init(filters[-1])
        in_ch = filters[-1]
    params["conv_2"] = conv2d_init(rng, 3, in_ch, 32, use_bias=True)
    return params


def prepare_flow_autoencoder(params, dtype: torch.dtype, path=None):
    """Raw params -> serving params in ``dtype``: every conv
    (``prepare_conv``) and every batch norm as a ``(scale, offset)``
    pair in ``dtype``, NOT folded: the reference's autoencoder runs the
    conv, then ``x * scale + offset`` in the compute dtype, and in bf16
    a fold would round at another place (``path``: the net's dotted
    path, for calibration)."""
    sub = (lambda k: None) if path is None else (lambda k: f"{path}.{k}")
    out = {}
    for name, p in params.items():
        if name.startswith("block_"):
            out[name] = {
                **{f"conv_{i}": prepare_conv(p[f"conv_{i}"], dtype,
                                             sub(f"{name}.conv_{i}"))
                   for i in (1, 2)},
                **{f"bn_{i}": prepare_bn(p[f"bn_{i}"], dtype)
                   for i in (1, 2)}}
    if "conv_1" in params:
        out["conv_1"] = prepare_conv(params["conv_1"], dtype, sub("conv_1"))
        out["bn_1"] = prepare_bn(params["bn_1"], dtype)
    out["conv_2"] = prepare_conv(params["conv_2"], dtype, sub("conv_2"))
    return out


def _bn_act(bn, x: torch.Tensor, act) -> torch.Tensor:
    """``offset + x * scale`` in one op, then act."""
    return act(batch_norm_apply(bn, x))


def _max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool of NHWC ``x``."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=2, stride=2)
    return out.permute(0, 2, 3, 1).contiguous()


def _upscale_2x_f32(x: torch.Tensor) -> torch.Tensor:
    return upscale_bilinear(x.float(), 2).to(x.dtype)


def flow_autoencoder_levels(params) -> int:
    """The autoencoder's pooling stages (half its ``block_i``)."""
    return sum(1 for k in params if k.startswith("block_")) // 2


def flow_autoencoder_apply(params, frames: List[torch.Tensor],
                           activation="relu", s2d_output: bool = False,
                           ops: WholeFrame = WHOLE_FRAME) -> torch.Tensor:
    """Autoencoder FNet: down (conv-bn-act x2, 2x2 max pool) x K, up
    (conv-bn-act x2, x2 bilinear in float32) x K, the optional mid conv,
    the 3x3 head, d2s(4) unless ``s2d_output``.  The ladder follows the
    param tree (``flow_autoencoder_levels``); ``params`` as
    ``prepare_flow_autoencoder`` gives them; ``ops``: how each layer
    runs (``models.common.WholeFrame``), on a grid that halves at each
    pool and doubles at each upscale."""
    act = get_activation(activation)
    levels = flow_autoencoder_levels(params)
    out = ops.map(concat, *frames)
    for i in range(2 * levels):
        name = f"block_{i + 1}"
        p = params[name]
        for j in ("1", "2"):
            out = ops.map(_bn_act, p["bn_" + j],
                          ops.conv(p["conv_" + j], out), act)
        if i < levels:
            out = ops.map(_max_pool_2x, out)
            ops = ops.scaled(1, 2)
        else:
            out = ops.upscale(2, _upscale_2x_f32, out)
            ops = ops.scaled(2)
        out = ops.record(f"flow.{name}", out)
    if "conv_1" in params:  # odd filter list: mid conv after the ladder
        out = ops.record("flow.conv_1", ops.map(
            _bn_act, params["bn_1"], ops.conv(params["conv_1"], out), act))
    out = ops.record("flow.conv_2", ops.conv(params["conv_2"], out))
    if s2d_output:
        return out
    return ops.map(depth_to_space, out, 4)


def flow_autoencoder_train(params, frames: List[torch.Tensor],
                           mut: Mutables,
                           activation="relu") -> torch.Tensor:
    """``flow_autoencoder_apply`` on raw params in training form."""
    act = get_train_activation(activation)
    levels = flow_autoencoder_levels(params)
    out = torch.cat(frames, dim=-1)
    for i in range(2 * levels):
        name = f"block_{i + 1}"
        p = params[name]
        for j in ("1", "2"):
            out = act(mut.bn(p["bn_" + j], f"{name}.bn_{j}",
                             conv2d(p["conv_" + j], out)))
        if i < levels:
            out = _max_pool_2x(out)
        else:
            out = _upscale_2x_f32(out)
    if "conv_1" in params:
        out = act(mut.bn(params["bn_1"], "bn_1",
                         conv2d(params["conv_1"], out)))
    return depth_to_space(conv2d(params["conv_2"], out), 4)
