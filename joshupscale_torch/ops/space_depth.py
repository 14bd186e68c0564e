"""Space/depth rearrangement in ``tf.nn.space_to_depth`` (DCR) order.

Port of ``joshupscale_tpu/ops/space_depth.py``:
``out[..., (dy*bs + dx)*C + c] = in[b, y*bs+dy, x*bs+dx, c]``.
``torch.pixel_shuffle`` / ``pixel_unshuffle`` use the CRD order
(``c*bs*bs + dy*bs + dx``) and would scramble the trained weights'
channels, so the reshape/permute is written out.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """NHWC space-to-depth: (N, H, W, C) -> (N, H/bs, W/bs, bs*bs*C)."""
    n, h, w, c = x.shape
    bs = int(block_size)
    x = x.reshape(n, h // bs, bs, w // bs, bs, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // bs, w // bs, bs * bs * c)


def depth_to_space(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """NHWC depth-to-space: (N, H, W, bs*bs*C) -> (N, H*bs, W*bs, C)."""
    n, h, w, c = x.shape
    bs = int(block_size)
    c_out = c // (bs * bs)
    x = x.reshape(n, h, w, bs, bs * c_out)
    x = x.permute(0, 1, 3, 2, 4)
    return x.reshape(n, h * bs, w * bs, c_out)
