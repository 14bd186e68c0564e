"""TF1-semantics bilinear upscale (align_corners=False, half_pixel=False).

Port of the integer-factor path of ``joshupscale_tpu/ops/resize.py``.
The model family was trained on the legacy TF1 grid
``src = dst * (in_size / out_size)`` with no half-pixel shift; no torch
resize mode reproduces it.  For scale ``s`` output pixel ``(s*i + ry,
s*j + rx)`` samples ``(i + ry/s, j + rx/s)``, so the op is a fixed 2x2
phase kernel on a trailing-edge-padded frame followed by
``depth_to_space``.
"""

from __future__ import annotations

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
    out = phase_upscale(x, phase_kernel(s, x.shape[-1], x.dtype, x.device))
    if skip_d2s:
        return out
    return depth_to_space(out, s)


def upscale_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upscale, TF1 legacy grid, edge clamped."""
    s = int(scale)
    if s == 1:
        return x
    if x.shape[-1] > 8:
        raise NotImplementedError(
            "upscale_bilinear for more than 8 channels (the broadcast "
            "path) is not ported yet; it waits for the PS2-family slice")
    return _upscale_bilinear_conv(x, s)
