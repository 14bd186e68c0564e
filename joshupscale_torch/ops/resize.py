"""TF1-semantics bilinear resize (align_corners=False, half_pixel=False).

Port of ``joshupscale_tpu/ops/resize.py``.  The model family was trained
on the legacy TF1 grid ``src = dst * (in_size / out_size)`` with no
half-pixel shift; no torch resize mode reproduces it.  For an integer
scale ``s`` output pixel ``(s*i + ry, s*j + rx)`` samples ``(i + ry/s, j +
rx/s)``: up to 8 channels that is a fixed 2x2 phase kernel on a
trailing-edge-padded frame followed by ``depth_to_space``; wider tensors
take the broadcast form (the phase kernel would be a large block
diagonal).  Other sizes gather rows and columns by per-axis tables.

Constant tables on a device (phase kernels, broadcast weights, per-axis
indices) are built once per shape, dtype and device and kept, so a step
that resizes copies nothing from the host after its first call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.ops.space_depth import depth_to_space


def _edge_pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Pad H and W of NHWC ``x`` by one trailing edge-clamped row/col."""
    x = torch.cat([x, x[:, -1:, :, :]], dim=1)
    return torch.cat([x, x[:, :, -1:, :]], dim=2)


def phase_kernel(s: int, c: int, dtype: torch.dtype = torch.float32,
                 device="cpu") -> torch.Tensor:
    """The bilinear x``s`` phase kernel, OIHW ``(s*s*c, c, 2, 2)``: output
    channel ``(ry*s + rx)*c + ch`` takes ``wy[ry, dy] * wy[rx, dx]`` of
    input channel ``ch`` at tap ``(dy, dx)``, with wy[r] = (1 - r/s, r/s).
    A constant: build it once per device and dtype."""
    r = np.arange(s, dtype=np.float64) / s
    wy = np.stack([1 - r, r], axis=1)  # (s, 2)
    taps = np.einsum("ay,bx->abyx", wy, wy).reshape(s * s, 1, 1, 2, 2)
    kernel = taps * np.eye(c)[None, :, :, None, None]  # (s*s, c, c, 2, 2)
    return torch.from_numpy(
        kernel.reshape(s * s * c, c, 2, 2).astype(np.float32)).to(
            device, dtype)


# The device constants below are cached per key and never evicted: a
# captured CUDA graph (runtime/engine.py) reads them by address.
_cached_phase_kernel = functools.cache(phase_kernel)


def phase_upscale(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Edge-pad + the 2x2 ``phase_kernel`` conv: the bilinear upscale of
    NHWC ``x`` as s2d-form phase channels (N, H, W, s*s*C)."""
    xp = _edge_pad_hw(x)  # (N, H+1, W+1, C)
    out = F.conv2d(xp.permute(0, 3, 1, 2), kernel)
    return out.permute(0, 2, 3, 1).contiguous()


def _upscale_bilinear_conv(x: torch.Tensor, s: int,
                           skip_d2s: bool = False) -> torch.Tensor:
    """Exact TF1 bilinear upscale as edge-pad + 2x2 conv + depth_to_space.

    ``skip_d2s=True`` returns the s2d-form phase channels
    (N, H, W, s*s*C) for consumers that stay in s2d space.
    """
    out = phase_upscale(x, _cached_phase_kernel(s, x.shape[-1], x.dtype,
                                                x.device))
    if skip_d2s:
        return out
    return depth_to_space(out, s)


@functools.cache
def _broadcast_weights(s: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(4, 1, 1, s, 1, s, 1) weights of the corners x00, x01, x10, x11
    for each output phase (ry, rx), float32 as the reference computes
    them, then cast to ``dtype``.  A constant, kept per device."""
    ry = (np.arange(s, dtype=np.float32) / s).reshape(s, 1)
    rx = (np.arange(s, dtype=np.float32) / s).reshape(1, s)
    w = np.stack([(1 - ry) * (1 - rx), (1 - ry) * rx, ry * (1 - rx),
                  ry * rx]).astype(np.float32)
    return torch.from_numpy(w).to(device, dtype).view(4, 1, 1, s, 1, s, 1)


def upscale_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upscale, TF1 legacy grid, edge clamped.

    Wide tensors (more than 8 channels) take the broadcast form: output
    (N, H, s, W, s, C) is ``x00*w00 + x01*w01 + x10*w10 + x11*w11`` in
    that order, in ``x.dtype``, each corner broadcast over the phases.
    """
    n, h, w, c = x.shape
    s = int(scale)
    if s == 1:
        return x
    if c <= 8:
        return _upscale_bilinear_conv(x, s)
    xp = _edge_pad_hw(x)[:, :, None, :, None, :]  # (N, H+1, 1, W+1, 1, C)
    wts = _broadcast_weights(s, x.dtype, x.device)
    out = xp[:, :h, :, :w] * wts[0]
    out = out + xp[:, :h, :, 1:] * wts[1]
    out = out + xp[:, 1:, :, :w] * wts[2]
    out = out + xp[:, 1:, :, 1:] * wts[3]
    return out.reshape(n, h * s, w * s, c)


def upscale_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour x``scale`` upscale on the TF1 legacy grid: the
    source of output pixel ``y`` is ``floor(y / scale)``, plain pixel
    replication (NHWC)."""
    s = int(scale)
    if s == 1:
        return x
    n, h, w, c = x.shape
    out = x[:, :, None, :, None, :].expand(n, h, s, w, s, c)
    return out.reshape(n, h * s, w * s, c)


def _tf1_indices(out_size: int, in_size: int):
    """Legacy-grid source indices and weights for one axis (numpy)."""
    scale = in_size / out_size
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - np.floor(src)).astype(np.float32)
    return lo, hi, frac


@functools.cache
def _tf1_tables(out_size: int, in_size: int, dtype: torch.dtype, device):
    lo, hi, frac = _tf1_indices(out_size, in_size)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.from_numpy(frac).to(device, dtype))


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """General-size TF1 nearest resize (align_corners=F, half_pixel=F):
    output row ``y`` takes input row ``floor(y * h / out_h)``, and the
    same for columns.  An integer upscale by the same factor on both
    axes goes to ``upscale_nearest``."""
    n, h, w, c = x.shape
    if out_h % h == 0 and out_w % w == 0 and out_h // h == out_w // w:
        return upscale_nearest(x, out_h // h)
    ylo = _tf1_tables(out_h, h, x.dtype, x.device)[0]
    xlo = _tf1_tables(out_w, w, x.dtype, x.device)[0]
    return x[:, ylo][:, :, xlo]


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """General-size TF1 bilinear resize (align_corners=F, half_pixel=F).

    An integer upscale by the same factor on both axes goes to
    ``upscale_bilinear``; other sizes interpolate rows, then columns.
    """
    n, h, w, c = x.shape
    if out_h % h == 0 and out_w % w == 0 and out_h // h == out_w // w:
        return upscale_bilinear(x, out_h // h)
    ylo, yhi, yf = _tf1_tables(out_h, h, x.dtype, x.device)
    xlo, xhi, xf = _tf1_tables(out_w, w, x.dtype, x.device)
    top = x[:, ylo]
    bot = x[:, yhi]
    row = top + (bot - top) * yf.view(1, out_h, 1, 1)
    left = row[:, :, xlo]
    right = row[:, :, xhi]
    return left + (right - left) * xf.view(1, 1, out_w, 1)
