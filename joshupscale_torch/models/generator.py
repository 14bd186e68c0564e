"""Generator, resnet architecture.

Port of ``generator_resnet_init``, ``generator_resnet_apply`` and
``_tail_s2d`` from ``joshupscale_tpu/models/generator.py``:
concat(frame, s2d(pre_warp)) -> conv -> res blocks -> tail.  The s2d
tail (the serving form) runs deconv1 as a 1x1 product to (dy1, dx1, 32)
channels, tiled bn_2 + act, deconv2 as a block-diagonal 1x1 product in
depth_to_space(4) channel order, tanh, + the TF1-bilinear x4 skip as
phase channels -> clip; the pixel tail runs the two deconvs, bn_2 and
the skip on the HR grid.  Without a ``pre_warp`` (``remove_flow``) the
first conv sees the frame alone.  ``generator_resnet_apply`` takes the
serving params that ``prepare_generator_resnet`` makes once from the raw
ones: folds, the tiled bn_2, the block-diagonal deconv2 product and the
bilinear phase kernel are constants of the step, built ahead of it.
``generator_resnet_train`` runs the raw params in training form (the
pixel tail, as the reference trains).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from joshupscale_torch.models.common import (
    Mutables,
    conv_bn_apply,
    conv_bn_train,
    prepare_conv_bn,
    prepare_res_blocks,
    res_block_init,
    res_blocks_apply,
    res_blocks_train,
)
from joshupscale_torch.nn.layers import (
    batch_norm_init,
    conv2d_init,
    conv2d_transpose_2x,
    deconv_kernel,
    fold_bn,
    get_activation,
    get_train_activation,
    glorot_uniform,
)
from joshupscale_torch.ops.image import clip
from joshupscale_torch.ops.resize import (
    phase_kernel,
    phase_upscale,
    upscale_bilinear,
)
from joshupscale_torch.ops.space_depth import depth_to_space, space_to_depth


def deconv_matrix(kernel: np.ndarray) -> np.ndarray:
    """Deconv kernel (2, 2, O, I) -> the equivalent 1x1 product
    (I, 4*O) with output channel ``(dy*2 + dx)*O + o``."""
    _, _, out_ch, in_ch = kernel.shape
    return np.ascontiguousarray(
        kernel.transpose(3, 0, 1, 2).reshape(in_ch, 4 * out_ch))


def _deconv_init(rng: np.random.Generator, in_ch: int, out_ch: int,
                 use_bias: bool):
    kernel = glorot_uniform(rng, (2, 2, out_ch, in_ch), 4 * in_ch,
                            4 * out_ch)
    params = {"kernel": torch.from_numpy(deconv_matrix(kernel))}
    if use_bias:
        params["bias"] = torch.zeros(out_ch)
    return params


def generator_resnet_init(rng: np.random.Generator, num_filters: int = 64,
                          num_res_blocks: int = 24,
                          num_fade_in_res_blocks: int = 0,
                          fade_in_period: int = 0,
                          zero_init_tail: bool = False):
    params = {
        "conv_1": conv2d_init(rng, 3, 51, num_filters, use_bias=False),
        "bn_1": batch_norm_init(num_filters),
        "conv_trans_1": _deconv_init(rng, num_filters, 32, use_bias=False),
        "bn_2": batch_norm_init(32),
        "conv_trans_2": _deconv_init(rng, 32, 3, use_bias=True),
    }
    total = num_res_blocks + num_fade_in_res_blocks
    for i in range(total):
        params[f"block_{i + 1}"] = res_block_init(
            rng, num_filters,
            fade_in_period=fade_in_period if i >= num_res_blocks else None)
    if zero_init_tail:
        params["conv_trans_2"] = {k: torch.zeros_like(v)
                                  for k, v in params["conv_trans_2"].items()}
    return params


def generator_resnet_apply(params, frame: torch.Tensor,
                           pre_warp: Optional[torch.Tensor],
                           activation="relu",
                           s2d_output: bool = True) -> torch.Tensor:
    """(frame, warped previous output) -> refined output.

    With ``s2d_output`` (the serving form) ``pre_warp`` is taken in s2d
    form (N, H, W, 48) and the output is s2d too (N, H, W, 48); without
    it ``pre_warp`` is the HR frame (N, 4H, 4W, 3) and so is the output.
    ``pre_warp=None`` is the non-temporal variant (``remove_flow``): the
    generator sees the frame alone.  ``params`` as
    ``prepare_generator_resnet`` gives them for the same ``s2d_output``
    and ``frame_only = pre_warp is None``.
    """
    act = get_activation(activation)
    num_blocks = sum(1 for k in params if k.startswith("block_"))
    conv_1 = params["conv_1"].get("conv", params["conv_1"])
    in_ch = (conv_1["kernel"].shape[-1] if "kernel" in conv_1
             else conv_1["in_channels"])
    if pre_warp is None:
        inp = frame
    else:
        inp = torch.cat([frame, pre_warp if s2d_output
                         else space_to_depth(pre_warp, 4)], dim=-1)
    if inp.shape[-1] != in_ch:
        raise ValueError(
            f"conv_1 takes {in_ch} channels but the input has "
            f"{inp.shape[-1]}: prepare the params with frame_only="
            f"{pre_warp is None}")
    out = act(conv_bn_apply(params["conv_1"], inp))
    out = res_blocks_apply(
        params, [f"block_{i + 1}" for i in range(num_blocks)], out,
        activation)
    if s2d_output:
        return _tail_s2d(params, frame, out, act)
    return _tail_pixel(params["pixel_tail"], frame, out, act)


def _d2s_group_selector() -> np.ndarray:
    """sel[g, p, q] = 1 where deconv1 group g = (dy1, dx1) and deconv2
    sub-phase q = (dy2, dx2) land on depth_to_space(4) phase
    p = ry*4 + rx with ry = 2*dy1 + dy2, rx = 2*dx1 + dx2."""
    sel = np.zeros((4, 16, 4), np.float32)
    for dy1 in range(2):
        for dx1 in range(2):
            for dy2 in range(2):
                for dx2 in range(2):
                    ry, rx = 2 * dy1 + dy2, 2 * dx1 + dx2
                    sel[dy1 * 2 + dx1, ry * 4 + rx, dy2 * 2 + dx2] = 1.0
    return sel


def _block_diag_deconv2(w: torch.Tensor) -> torch.Tensor:
    """deconv2's (mid, 4*out) product -> the block-diagonal
    (4*mid, 16*out) product from deconv1's 4 groups to d2s4 phases."""
    mid, four_out = w.shape
    out_ch = four_out // 4
    sel = torch.from_numpy(_d2s_group_selector()).to(w.device)
    w2 = torch.einsum("gpq,mqo->gmpo", sel, w.float().view(mid, 4, out_ch))
    return w2.reshape(4 * mid, 16 * out_ch)


def prepare_generator_resnet(params, dtype: torch.dtype,
                             s2d_output: bool = True,
                             frame_only: bool = False, path=None):
    """Raw params -> serving params in ``dtype``: ``conv_1`` with
    ``bn_1`` (folded when float, outside calibration; cut to the 3 frame
    channels with ``frame_only``, the non-temporal variant), every res
    block, and the tail's constants.  Int8 deconvs are dequantized here,
    once, in float32 (``deconv_kernel``).  The s2d tail (``s2d_output``)
    takes deconv1's product and bias, bn_2 tiled over deconv1's 4 groups
    as a scale and offset, deconv2 as the block-diagonal product and
    bias in d2s4 order, and the x4 bilinear phase kernel; the pixel tail
    (``"pixel_tail"``) the two deconv products and biases, bn_2 and the
    phase kernel.

    ``path`` (the calibration route) labels the convs the reference's
    sweep records: not a ``frame_only`` ``conv_1`` (the reference cuts
    it into a new array, which its sweep does not know) and the deconvs
    only in the pixel tail (its s2d tail runs them as plain products).
    """
    sub = (lambda k: None) if path is None else (lambda k: f"{path}.{k}")
    ct1, ct2 = params["conv_trans_1"], params["conv_trans_2"]
    conv_1 = params["conv_1"]
    if frame_only:
        key = "kernel_q" if "kernel_q" in conv_1 else "kernel"
        conv_1 = {**conv_1, key: conv_1[key][..., :3]}
    scale, offset = fold_bn(params["bn_2"])
    w1, w2 = deconv_kernel(ct1), deconv_kernel(ct2)
    skip = phase_kernel(4, 3, dtype, w1.device)
    out = {**prepare_res_blocks(params, dtype, path),
           "conv_1": prepare_conv_bn(conv_1, params["bn_1"], dtype,
                                     sub("conv_1"))}
    if frame_only and path is not None:
        # Unfolded for calibration, but not recorded.
        out["conv_1"]["conv"].pop("path", None)
    if not s2d_output:
        tail = {}
        for name, ct, w in (("conv_trans_1", ct1, w1),
                            ("conv_trans_2", ct2, w2)):
            tail[name] = {"kernel": w.to(dtype)}
            if "bias" in ct:
                tail[name]["bias"] = ct["bias"].to(dtype)
            if path is not None and "kernel_q" not in ct:
                tail[name]["path"] = sub(name)
        out["pixel_tail"] = {
            **tail,
            "bn_2": {"scale": scale.to(dtype), "offset": offset.to(dtype)},
            "skip": skip,
        }
        return out
    tail_1 = {"kernel": w1.to(dtype)}
    if "bias" in ct1:
        tail_1["bias"] = ct1["bias"].repeat(4).to(dtype)
    tail_2 = {"kernel": _block_diag_deconv2(w2).to(dtype)}
    if "bias" in ct2:
        tail_2["bias"] = ct2["bias"].repeat(16).to(dtype)
    return {
        **out,
        "conv_trans_1": tail_1,
        "bn_2": {"scale": scale.repeat(4).to(dtype),
                 "offset": offset.repeat(4).to(dtype)},
        "conv_trans_2": tail_2,
        "skip": skip,
    }


def _tail_s2d(params, frame: torch.Tensor, out: torch.Tensor,
              act) -> torch.Tensor:
    """Generator tail in space-to-depth form (see module docstring);
    equal to deconv2x -> BN -> act -> deconv2x -> tanh -> + bilinear4
    -> clip followed by space_to_depth(4)."""
    ct1, bn, ct2 = (params["conv_trans_1"], params["bn_2"],
                    params["conv_trans_2"])
    x = torch.matmul(out, ct1["kernel"])
    if "bias" in ct1:
        x = x + ct1["bias"]
    x = act(x * bn["scale"] + bn["offset"])
    x = torch.matmul(x, ct2["kernel"])
    if "bias" in ct2:
        x = x + ct2["bias"]
    x = torch.tanh(x)
    upscaled = phase_upscale(frame, params["skip"])
    return torch.clamp(upscaled + x, -0.5, 0.5)


def _tail_pixel(params, frame: torch.Tensor, out: torch.Tensor,
                act) -> torch.Tensor:
    """Generator tail in pixel form: deconv2x -> BN -> act -> deconv2x
    -> tanh -> + bilinear4(frame) -> clip, (N, 4H, 4W, 3)."""
    bn = params["bn_2"]
    x = conv2d_transpose_2x(params["conv_trans_1"], out)
    x = act(x * bn["scale"] + bn["offset"])
    x = torch.tanh(conv2d_transpose_2x(params["conv_trans_2"], x))
    upscaled = depth_to_space(phase_upscale(frame, params["skip"]), 4)
    return torch.clamp(upscaled + x, -0.5, 0.5)


def generator_resnet_train(params, frame: torch.Tensor,
                           pre_warp: Optional[torch.Tensor], mut: Mutables,
                           activation="relu") -> torch.Tensor:
    """``generator_resnet_apply`` on raw params in training form, pixel
    tail: (frame, warped previous HR output) -> (N, 4H, 4W, 3); bn_2
    takes its statistics on the 2x grid after deconv1, and the final
    clip passes the reference's gradient at its bounds.
    ``pre_warp=None``: the frame alone (conv_1 cut to its 3 frame
    channels)."""
    act = get_train_activation(activation)
    num_blocks = sum(1 for k in params if k.startswith("block_"))
    conv_1 = params["conv_1"]
    if pre_warp is None:
        inp = frame
        conv_1 = {**conv_1, "kernel": conv_1["kernel"][..., :3]}
    else:
        inp = torch.cat([frame, space_to_depth(pre_warp, 4)], dim=-1)
    out = act(conv_bn_train(conv_1, params["bn_1"], inp, mut, "bn_1"))
    out = res_blocks_train(
        params, [f"block_{i + 1}" for i in range(num_blocks)], out,
        activation, mut)
    out = conv2d_transpose_2x(params["conv_trans_1"], out)
    out = act(mut.bn(params["bn_2"], "bn_2", out))
    out = torch.tanh(conv2d_transpose_2x(params["conv_trans_2"], out))
    return clip(upscale_bilinear(frame, 4) + out, -0.5, 0.5)
