"""Functional conv / batch-norm layers.

Port of ``joshupscale_tpu/nn/layers.py``: the inference layers, and
batch norm in training form (``batch_norm_train``).  Activations are
NHWC.  Conv kernels are stored OHWI ``(out, kh, kw, in)``:
``kernel.permute(0, 3, 1, 2)`` is the OIHW view ``F.conv2d`` takes
(channels-last strides, no copy), and the res-block kernel
(``kernels/resblock.py``) reads OHWI directly.  Kernel-2 stride-2
deconvs are stored as their (I, 4*O) 1x1 product.
``export/weights.py`` converts the reference's kernels.

Int8-quantized layers (``export/quantize.py``) hold ``kernel_q`` (int8,
same layout), ``kernel_scale`` (float32, per leading axis: a conv's
output channels, a deconv product's input rows) and optionally a static
``act_scale``.  ``prepare_conv_int8`` makes a conv's once, ahead of
serving, and ``conv2d`` runs them as the reference's int8 conv
(``conv2d_int8``); a deconv's weights are dequantized once
(``deconv_kernel``).

A calibration sweep (``export/quantize.calibrate``) sees each conv's
input through ``recording``: prepared params that carry a ``"path"``
report their input to the active recorder.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.ops.space_depth import depth_to_space

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


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


# Called as ``record(path, x)`` with each labelled conv's input while a
# calibration sweep runs (``recording``); None otherwise.
_recorder: Optional[Callable[[str, torch.Tensor], None]] = None


@contextlib.contextmanager
def recording(record: Callable[[str, torch.Tensor], None]):
    """Within the block, every conv (and deconv) whose params carry a
    ``"path"`` calls ``record(path, x)`` with its input ``x``."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a calibration sweep is already recording")
    _recorder = record
    try:
        yield
    finally:
        _recorder = None


def _record(params, x: torch.Tensor) -> None:
    if _recorder is not None and "path" in params:
        _recorder(params["path"], x)


def conv2d(params, x: torch.Tensor) -> torch.Tensor:
    """NHWC SAME conv, stride 1, OHWI kernel; output dtype = input dtype.

    A plain library conv: used for the first convs and the 1x1 heads,
    outside any kernel of the reference.  Int8 params (as
    ``prepare_conv_int8`` makes them) run ``conv2d_int8``.
    """
    _record(params, x)
    if "matrix_q" in params:
        return conv2d_int8(params, x)
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


# The reference's compiled step computes ``absmax / 127.0`` as a product
# with the float32 reciprocal (XLA folds a division by a constant), so
# the dynamic scale does too.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b_t (K, N)`` of int8 matrices in exact int32:
    ``torch._int_mm``, with ``a`` row-major, ``b_t`` the transpose of a
    row-major (N, K) matrix, K and N multiples of 8 and, as the card's
    version asks, M over 16 (short ``a`` gets zero rows)."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 32 - m))
    out = torch._int_mm(a, b_t)
    return out[:m] if m <= 16 else out


def prepare_conv_int8(params):
    """Int8 conv params (``kernel_q`` OHWI, ``kernel_scale``, optional
    ``bias`` and ``act_scale``) -> ``conv2d_int8``'s, made once: the
    kernel as the row-major (O, k*k*I) matrix of the product
    (``matrix_q``; I and then O zero-padded to multiples of 8, as
    ``torch._int_mm`` asks: zeros add nothing), its tap count and input
    channels, and the scales and bias in float32."""
    kq = params["kernel_q"]
    out_ch, k, _, c = kq.shape
    if k % 2 == 0:
        raise ValueError(f"SAME padding needs an odd kernel, got {k}")
    cin = c + (-c % 8)
    wq = F.pad(kq, (0, cin - c)).reshape(out_ch, k * k * cin)
    out = {"matrix_q": F.pad(wq, (0, 0, 0, -out_ch % 8)).contiguous(),
           "taps": k, "in_channels": c,
           "kernel_scale": params["kernel_scale"].float()}
    for key in ("bias", "act_scale"):
        if key in params:
            out[key] = params[key].float()
    return out


def conv2d_int8(params, x: torch.Tensor) -> torch.Tensor:
    """The reference's int8 conv (``_conv2d_int8``), NHWC SAME, stride 1,
    on ``prepare_conv_int8``'s params.

    The activation scale is ``act_scale`` (static, calibrated) or
    ``max(max|x|, 1e-6) / 127`` of this input (dynamic, on the device);
    ``x / act_scale`` (a true division: a product with the reciprocal
    would move ties) is rounded half to even and clipped to +-127 as
    int8; the int8 product sums in exact int32; the result is
    ``float32(sum) * (act_scale * kernel_scale)`` (the two scales
    multiplied first, as the reference does), plus the bias in float32
    (fused, one rounding), cast to ``x.dtype``.

    The product is an im2col of the int8 input (the k*k taps in OHWI
    order, SAME zero padding, the channels zero-padded to a multiple of
    8 in input and kernel) times the (O, k*k*I) kernel in one
    ``torch._int_mm``, on the CPU and on the card alike -- a plain
    product, as the reference leaves its int8 conv to XLA.  No float
    conv or matmul stands in for it: float32 sums are exact only while
    127^2 * K < 2^24 (K <= 1040), and cuDNN convs default to TF32.
    """
    k, c = params["taps"], params["in_channels"]
    out_ch = params["kernel_scale"].shape[0]
    if x.shape[-1] != c:
        raise ValueError(f"the kernel takes {c} channels, the input has "
                         f"{x.shape[-1]}")
    # The input's channels zero-padded as the kernel's, so that K =
    # k*k*cin is a multiple of 8.
    cin = c + (-c % 8)
    static = "act_scale" in params
    if static:
        act_scale = params["act_scale"].float()
    else:
        act_scale = torch.clamp(x.abs().amax().float(), min=1e-6) * _INV_127
    # A 1-element (not 0-dim) scale makes the quotient float32 in one
    # pass over a bf16 input.
    q = torch.div(x, act_scale.reshape(1)).round_()
    if static:
        # A dynamic scale bounds |x / act_scale| by 127 already.
        q.clamp_(-127, 127)
    n, h, w, _ = x.shape
    p = k // 2
    # The int8 input, SAME-padded and channel-padded with zeros, written
    # in one cast.
    xp = torch.zeros((n, h + 2 * p, w + 2 * p, cin), dtype=torch.int8,
                     device=x.device)
    xp[:, p:p + h, p:p + w, :c].copy_(q)
    # im2col: each pixel's k*k taps side by side, moved as 8-byte words
    # (cin is a multiple of 8).
    words = xp.view(torch.int64)
    sn, sh, sw, _ = words.stride()
    cols = torch.as_strided(words, (n, h, w, k, k, cin // 8),
                            (sn, sh, sw, sh, sw, 1))
    cols = cols.reshape(n * h * w, k * k * cin // 8).view(torch.int8)
    acc = _int_mm(cols, params["matrix_q"].t())
    if acc.shape[1] != out_ch:
        acc = acc[:, :out_ch]
    scale = act_scale * params["kernel_scale"].float()
    out = torch.empty((n * h * w, out_ch), dtype=x.dtype, device=x.device)
    if "bias" in params:
        # One rounding, as the reference's compiled multiply-add (FMA).
        torch.addcmul(params["bias"].float(), acc.float(), scale, out=out)
    else:
        torch.mul(acc, scale, out=out)
    return out.reshape(n, h, w, out_ch)


def deconv_kernel(params) -> torch.Tensor:
    """A deconv's (I, 4*O) product in float32, dequantized for int8
    params (``kernel_q * kernel_scale`` per input row, the reference's
    weight-only dequantization)."""
    if "kernel_q" in params:
        return (params["kernel_q"].float()
                * params["kernel_scale"].float().reshape(-1, 1))
    return params["kernel"]


def conv2d_transpose_2x(params, x: torch.Tensor) -> torch.Tensor:
    """Transposed conv, kernel 2, stride 2, on the stored 1x1 product:
    ``params["kernel"]`` is (I, 4*O) with output channel
    ``(dy*2 + dx)*O + o`` (``export/weights.py`` makes it from the
    reference's (2, 2, O, I) kernel; an int8 one dequantized by
    ``deconv_kernel``).  The product, ``depth_to_space(2)``, then the
    bias, in ``x.dtype``: the taps of a kernel-2 stride-2 deconv do not
    overlap, so this is the deconv exactly."""
    _record(params, x)
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


def batch_norm_train(params, x: torch.Tensor, eps: float = BN_EPS):
    """Training batch norm (Keras semantics): ``(y, new_stats)``.

    The batch mean and the population variance are taken in float32
    over every axis but the channels, also for a bf16 ``x``; the output
    ``(x - mean) * gamma / sqrt(var + eps) + beta`` is computed in
    ``x.dtype``, as the reference's is.  ``new_stats`` holds the moving
    statistics after one momentum step (``BN_MOMENTUM``), detached: they
    are state, not part of the loss.
    """
    dims = tuple(range(x.ndim - 1))
    var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
    inv = (params["gamma"] * torch.rsqrt(var + eps)).to(x.dtype)
    y = (x - mean.to(x.dtype)) * inv + params["beta"].to(x.dtype)
    m = BN_MOMENTUM
    with torch.no_grad():
        new_stats = {
            "moving_mean": params["moving_mean"] * m + mean * (1 - m),
            "moving_variance": params["moving_variance"] * m
            + var * (1 - m),
        }
    return y, new_stats


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


def get_train_activation(
        activation) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation with the reference's gradient at 0: relu's is 0
    in both packages, but ``jax.nn.leaky_relu`` is ``where(x >= 0, x,
    alpha * x)``, slope 1 at 0 where ``F.leaky_relu`` gives alpha."""
    name, alpha = activation_spec(activation)
    if name == "relu":
        return relu
    return lambda x: torch.where(x >= 0, x, x * alpha)
