"""Shared model blocks: conv+BN folds, res blocks, the inference fade scale.

Port of the inference subset of ``joshupscale_tpu/models/common.py``.
Parameter trees mirror the reference's Keras layer names (``conv_1``,
``bn_1``, ``block_3``...).

Serving runs on params prepared once when an engine is built
(``InferenceModel.prepare_params``), so a frame redoes no fold.  As in
the reference, batch norm is folded into a conv only when the conv is
float (``joshupscale_tpu/models/common.py conv_bn``): a float res block
becomes what the res-block conv (K1, ``kernels/resblock.py``) takes and
runs as two K1 launches (``conv_1`` with the bn_1 epilogue and act, then
``conv_2`` with the bn_2 epilogue x the fade scale, the residual and
act).  An int8 conv keeps its batch norm as ``x * scale + offset`` in
the compute dtype after the conv, and so does every conv of the
calibration route: the prepare functions take the net's dotted
``path`` there, and a conv given a path is never folded and carries the
path for the sweep's recorder (``nn.layers.recording``).
"""

from __future__ import annotations

import numpy as np
import torch

from joshupscale_torch.kernels.resblock import resblock_conv3x3
from joshupscale_torch.nn.layers import (
    activation_spec,
    batch_norm_init,
    conv2d,
    conv2d_init,
    fold_bn,
    get_activation,
    prepare_conv_int8,
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


def prepare_conv(conv_params, dtype: torch.dtype, path=None):
    """A conv's serving params: a float kernel (and bias) cast to
    ``dtype``; an int8 one as ``prepare_conv_int8`` makes it.  With
    ``path`` a float conv carries it for the calibration recorder (the
    reference's sweep records float convs only)."""
    if "kernel_q" in conv_params:
        return prepare_conv_int8(conv_params)
    out = {k: conv_params[k].to(dtype) for k in ("kernel", "bias")
           if k in conv_params}
    if path is not None:
        out["path"] = path
    return out


def prepare_bn(bn_params, dtype: torch.dtype):
    """Inference batch norm as a ``(scale, offset)`` pair in ``dtype``."""
    scale, offset = fold_bn(bn_params)
    return {"scale": scale.to(dtype), "offset": offset.to(dtype)}


def _float(conv_params) -> bool:
    return "kernel_q" not in conv_params


def fold_conv_bn(conv_params, bn_params, dtype: torch.dtype):
    """A float conv followed by inference batch norm as one conv's
    params for ``conv2d``: ``kernel * inv`` per output channel and an
    offset bias (plus the conv's own bias times ``inv``), cast to
    ``dtype`` -- the fold the reference's ``conv_bn`` does at
    inference."""
    inv, offset = fold_bn(bn_params)
    if "bias" in conv_params:
        offset = offset + conv_params["bias"].float() * inv
    kernel = conv_params["kernel"].float() * inv.view(-1, 1, 1, 1)
    return {"kernel": kernel.to(dtype), "bias": offset.to(dtype)}


def prepare_conv_bn(conv_params, bn_params, dtype: torch.dtype,
                    path=None):
    """A conv and its batch norm: folded into one conv (a float conv
    outside calibration), else ``{"conv", "bn"}`` for
    ``conv_bn_apply``'s unfolded route (``path``: the conv's dotted
    path, given for calibration)."""
    if path is None and _float(conv_params):
        return fold_conv_bn(conv_params, bn_params, dtype)
    return {"conv": prepare_conv(conv_params, dtype, path),
            "bn": prepare_bn(bn_params, dtype)}


def batch_norm_apply(bn, x: torch.Tensor) -> torch.Tensor:
    """``x * scale + offset`` on a ``prepare_bn`` pair, in one op."""
    return torch.addcmul(bn["offset"], x, bn["scale"])


def conv_bn_apply(params, x: torch.Tensor) -> torch.Tensor:
    """A ``prepare_conv_bn`` result on ``x``: the folded conv, or the
    conv then batch norm in ``x.dtype``."""
    if "bn" in params:
        return batch_norm_apply(params["bn"], conv2d(params["conv"], x))
    return conv2d(params, x)


def _fold_conv(conv_params, bn_params, dtype, fade=None):
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


def unfold_res_block(params, dtype: torch.dtype, path=None):
    """Raw res-block params -> the unfolded route's: each conv
    (``prepare_conv``) with its batch norm in ``dtype`` and the fade
    scale in ``dtype`` (``path``: the block's dotted path)."""
    out = {}
    for i in ("1", "2"):
        out["conv_" + i] = prepare_conv(
            params["conv_" + i], dtype,
            None if path is None else f"{path}.conv_{i}")
        out["bn_" + i] = prepare_bn(params["bn_" + i], dtype)
    if "fade" in params:
        out["fade"] = fade_scale(params["fade"]).to(dtype)
    return out


def prepare_res_blocks(params, dtype: torch.dtype, path=None):
    """Every ``block_*`` of a net's params: folded for K1
    (``fold_res_block``) when both convs are float, else unfolded
    (``unfold_res_block``); all unfolded under calibration (``path``:
    the net's dotted path)."""
    out = {}
    for k, v in params.items():
        if not k.startswith("block_"):
            continue
        if path is None and _float(v["conv_1"]) and _float(v["conv_2"]):
            out[k] = fold_res_block(v, dtype)
        else:
            out[k] = unfold_res_block(
                v, dtype, None if path is None else f"{path}.{k}")
    return out


def res_block_apply(params, x: torch.Tensor, activation) -> torch.Tensor:
    """conv-bn-act-conv-bn(-fade)-add-act residual block: two K1 calls
    on a block folded by ``fold_res_block``, or the reference's unfolded
    ops on one from ``unfold_res_block``."""
    if "bn_1" in params:
        act = get_activation(activation)
        out = act(batch_norm_apply(params["bn_1"],
                                   conv2d(params["conv_1"], x)))
        out = batch_norm_apply(params["bn_2"], conv2d(params["conv_2"], out))
        if "fade" in params:
            out = out * params["fade"]
        return act(out + x)
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
