"""Image value-range conversion and the brightness term (port of
``joshupscale_tpu/ops/image.py``).

Frames enter the network as BGR floats in ``[-0.5, 0.5]`` and leave as
uint8 via a truncating cast of ``(x + 0.5) * 255``.
"""

from __future__ import annotations

import functools

import torch

# ITU-R BT.601 luma in BGR channel order, as the reference weighs it.
BGR_LUMA = (0.1140, 0.5870, 0.2989)


class _Clip(torch.autograd.Function):
    """``clamp`` whose gradient is 1 inside the bounds, 0.5 on them and
    0 outside: the gradient of ``jnp.clip``, which is
    ``minimum(maximum(x, lo), hi)`` and splits a tie's gradient evenly;
    ``torch.clamp`` passes 1 on a bound."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(grad.dtype)
        on_bound = ((x == lo) | (x == hi)).to(grad.dtype)
        return grad * (inside + 0.5 * on_bound), None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x`` clipped to ``[lo, hi]``, with the reference's gradient (0.5
    where ``x`` equals a bound).  Training hits the bounds exactly: u8
    pixels 0 and 255 normalize to -0.5 and 0.5, and a zero flow puts
    every warp weight at 0.  Without grad it is ``torch.clamp``."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return _Clip.apply(x, lo, hi)


def preprocess(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> float [-0.5, 0.5]."""
    return x.to(dtype) / 255.0 - 0.5


def postprocess(x: torch.Tensor) -> torch.Tensor:
    """float [-0.5, 0.5] -> uint8 [0, 255], truncating (TF semantics).

    The add and the multiply are two separately rounded f32 ops, and the
    float -> uint8 conversion truncates toward zero; values are in
    [0, 255] because the generator clips to [-0.5, 0.5] upstream.
    """
    out = (x.to(torch.float32) + 0.5) * 255.0
    return out.to(torch.uint8)


@functools.cache
def _luma(dtype: torch.dtype, device) -> torch.Tensor:
    """``BGR_LUMA * 3`` rounded as the reference rounds it in ``dtype``
    (the weights cast first, then the product); a constant kept per
    device, never evicted: a captured CUDA graph reads it by address."""
    return (torch.tensor(BGR_LUMA, dtype=dtype) * 3.0).to(device)


def brightness(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """Mean BGR luma over an NHWC frame: ``mean(x * BGR_LUMA * 3)``.

    The products are rounded in ``x.dtype`` as the reference's are; the
    mean accumulates in float32 and rounds once to ``x.dtype``, as
    ``jnp.mean`` does.
    """
    b = (x * _luma(x.dtype, x.device)).float().mean(dim=(1, 2, 3))
    b = b.to(x.dtype)
    if keepdims:
        return b[:, None, None, None]
    return b
