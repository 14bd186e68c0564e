"""Functional conv / batch-norm layers, inference subset.

Port of ``joshupscale_tpu/nn/layers.py``.  Activations are NHWC.  Conv
kernels are stored OHWI ``(out, kh, kw, in)``: ``kernel.permute(0, 3,
1, 2)`` is the OIHW view ``F.conv2d`` takes (channels-last strides, no
copy), and the res-block kernel (``kernels/resblock.py``) reads OHWI
directly.  Kernel-2 stride-2 deconvs are stored as their (I, 4*O) 1x1
product.  ``export/weights.py`` converts the reference's kernels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.ops.space_depth import depth_to_space

BN_EPS = 1e-3


def glorot_uniform(rng: np.random.Generator, shape, fan_in: int,
                   fan_out: int) -> np.ndarray:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def conv2d_init(rng: np.random.Generator, kernel_size: int, in_ch: int,
                out_ch: int, use_bias: bool = True):
    """Conv param dict: OHWI kernel (+ optional zero bias)."""
    k = kernel_size
    params = {"kernel": torch.from_numpy(glorot_uniform(
        rng, (out_ch, k, k, in_ch), k * k * in_ch, k * k * out_ch))}
    if use_bias:
        params["bias"] = torch.zeros(out_ch)
    return params


def require_float_kernel(params) -> None:
    """Raise for int8-quantized layer params (not ported yet)."""
    if "kernel_q" in params:
        raise NotImplementedError(
            "int8 kernel_q params are not ported yet; they wait for the "
            "export/quantize slice")


def conv2d(params, x: torch.Tensor) -> torch.Tensor:
    """NHWC SAME conv, stride 1, OHWI kernel; output dtype = input dtype.

    A plain library conv: used for the first convs and the 1x1 heads,
    outside any kernel of the reference.
    """
    require_float_kernel(params)
    kernel = params["kernel"].to(x.dtype)
    k = kernel.shape[1]
    if k % 2 == 0:
        raise ValueError(f"SAME padding needs an odd kernel, got {k}")
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(0, 3, 1, 2),
                   padding=k // 2)
    out = out.permute(0, 2, 3, 1)
    if "bias" in params:
        out = out + params["bias"].to(x.dtype)
    return out.contiguous()


def conv2d_transpose_2x(params, x: torch.Tensor) -> torch.Tensor:
    """Transposed conv, kernel 2, stride 2, on the stored 1x1 product:
    ``params["kernel"]`` is (I, 4*O) with output channel
    ``(dy*2 + dx)*O + o`` (``export/weights.py`` makes it from the
    reference's (2, 2, O, I) kernel).  The product, ``depth_to_space(2)``,
    then the bias, in ``x.dtype``: the taps of a kernel-2 stride-2
    deconv do not overlap, so this is the deconv exactly."""
    require_float_kernel(params)
    out = depth_to_space(torch.matmul(x, params["kernel"].to(x.dtype)), 2)
    if "bias" in params:
        out = out + params["bias"].to(x.dtype)
    return out


def batch_norm_init(num_ch: int):
    return {
        "gamma": torch.ones(num_ch),
        "beta": torch.zeros(num_ch),
        "moving_mean": torch.zeros(num_ch),
        "moving_variance": torch.ones(num_ch),
    }


def fold_bn(bn_params, eps: float = BN_EPS):
    """Inference BN as a float32 ``(scale, offset)`` pair."""
    inv = bn_params["gamma"].float() * torch.rsqrt(
        bn_params["moving_variance"].float() + eps)
    offset = bn_params["beta"].float() - bn_params["moving_mean"].float() * inv
    return inv, offset


def batch_norm(params, x: torch.Tensor, eps: float = BN_EPS) -> torch.Tensor:
    """Inference batch norm (Keras semantics), folded to scale/offset in
    float32 and applied in ``x.dtype``."""
    inv, offset = fold_bn(params, eps)
    return x * inv.to(x.dtype) + offset.to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """LeakyReLU with the Keras default slope 0.3 (reference 'lrelu')."""
    return F.leaky_relu(x, negative_slope=alpha)


def activation_spec(activation) -> Tuple[str, float]:
    """Resolve an activation config (str or {'name': ..., ...}) to
    ``(name, alpha)``; ``alpha`` is only read for 'lrelu'."""
    if isinstance(activation, str):
        name, args = activation, {}
    elif isinstance(activation, dict):
        name = activation["name"]
        args = {k: v for k, v in activation.items() if k != "name"}
    else:
        raise TypeError(f"Unknown activation type: {activation!r}")
    if name == "relu":
        return name, 0.0
    if name == "lrelu":
        alpha = args.get("alpha")
        if alpha is None:
            alpha = args.get("negative_slope", 0.3)
        return name, float(alpha)
    raise ValueError(f"Unknown activation: {name}")


def get_activation(activation) -> Callable[[torch.Tensor], torch.Tensor]:
    name, alpha = activation_spec(activation)
    if name == "relu":
        return relu
    return lambda x: leaky_relu(x, alpha)
