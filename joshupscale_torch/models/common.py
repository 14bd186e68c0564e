"""Shared model blocks: conv+BN folds, res blocks, the inference fade scale.

Port of the inference subset of ``joshupscale_tpu/models/common.py``.
Parameter trees mirror the reference's Keras layer names (``conv_1``,
``bn_1``, ``block_3``...).

Serving runs on folded params, made once when an engine is built
(``InferenceModel.prepare_params``), so a frame redoes no fold.
``fold_conv_bn`` is the fold half of the reference's ``conv_bn`` (the
conv half is ``nn.layers.conv2d``); ``prepare_res_blocks`` folds every
res block into what the res-block conv (K1, ``kernels/resblock.py``)
takes.  A res block then runs as two K1 launches: ``conv_1`` with the
bn_1 epilogue and act, then ``conv_2`` with the bn_2 epilogue (x the
fade scale), the residual and act.
"""

from __future__ import annotations

import numpy as np
import torch

from joshupscale_torch.kernels.resblock import resblock_conv3x3
from joshupscale_torch.nn.layers import (
    activation_spec,
    batch_norm_init,
    conv2d_init,
    fold_bn,
    require_float_kernel,
)


def fade_scale(fade_params) -> torch.Tensor:
    """Inference fade-in scale ``min(counter / max(period, 1), 1)``
    (reference FadeInLayer at inference: a constant factor)."""
    counter = torch.as_tensor(fade_params["counter"]).float()
    period = torch.as_tensor(fade_params["period"]).float()
    return torch.clamp(counter / torch.clamp(period, min=1.0), max=1.0)


def res_block_init(rng: np.random.Generator, num_filters: int,
                   fade_in_period=None):
    params = {
        "conv_1": conv2d_init(rng, 3, num_filters, num_filters,
                              use_bias=False),
        "bn_1": batch_norm_init(num_filters),
        "conv_2": conv2d_init(rng, 3, num_filters, num_filters,
                              use_bias=False),
        "bn_2": batch_norm_init(num_filters),
    }
    if fade_in_period is not None:
        params["fade"] = {
            "counter": torch.zeros(()),
            "period": torch.tensor(float(fade_in_period)),
        }
    return params


def fold_conv_bn(conv_params, bn_params, dtype: torch.dtype):
    """A conv followed by inference batch norm as one conv's params for
    ``conv2d``: ``kernel * inv`` per output channel and an offset bias
    (plus the conv's own bias times ``inv``), cast to ``dtype`` -- the
    fold the reference's ``conv_bn`` does at inference."""
    require_float_kernel(conv_params)
    inv, offset = fold_bn(bn_params)
    if "bias" in conv_params:
        offset = offset + conv_params["bias"].float() * inv
    kernel = conv_params["kernel"].float() * inv.view(-1, 1, 1, 1)
    return {"kernel": kernel.to(dtype), "bias": offset.to(dtype)}


def _fold_conv(conv_params, bn_params, dtype, fade=None):
    require_float_kernel(conv_params)
    scale, offset = fold_bn(bn_params)
    if "bias" in conv_params:
        offset = offset + conv_params["bias"].float() * scale
    if fade is not None:
        scale = scale * fade
        offset = offset * fade
    return {"kernel": conv_params["kernel"].to(dtype).contiguous(),
            "scale": scale.contiguous(), "offset": offset.contiguous()}


def fold_res_block(params, dtype: torch.dtype):
    """Raw res-block params -> ``{"conv_1": {kernel, scale, offset},
    "conv_2": {...}}`` in K1's form (kernel OHWI in ``dtype``, scale and
    offset float32 with bn, conv bias and fade folded in)."""
    fade = fade_scale(params["fade"]) if "fade" in params else None
    return {
        "conv_1": _fold_conv(params["conv_1"], params["bn_1"], dtype),
        "conv_2": _fold_conv(params["conv_2"], params["bn_2"], dtype, fade),
    }


def prepare_res_blocks(params, dtype: torch.dtype):
    """Every ``block_*`` of a net's params, folded by ``fold_res_block``."""
    return {k: fold_res_block(v, dtype) for k, v in params.items()
            if k.startswith("block_")}


def res_block_apply(params, x: torch.Tensor, activation) -> torch.Tensor:
    """conv-bn-act-conv-bn(-fade)-add-act residual block: two K1 calls
    on a block folded by ``fold_res_block``."""
    act, alpha = activation_spec(activation)
    c1, c2 = params["conv_1"], params["conv_2"]
    y = resblock_conv3x3(x, c1["kernel"], c1["scale"], c1["offset"],
                         None, act, alpha)
    return resblock_conv3x3(y, c2["kernel"], c2["scale"], c2["offset"],
                            x, act, alpha)


def res_blocks_apply(params, names, x: torch.Tensor,
                     activation) -> torch.Tensor:
    """Run consecutive folded res blocks (see ``prepare_res_blocks``)."""
    out = x.contiguous()
    for name in names:
        out = res_block_apply(params[name], out, activation)
    return out
