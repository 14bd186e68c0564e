"""Image value-range conversion (port of ``joshupscale_tpu/ops/image.py``).

Frames enter the network as BGR floats in ``[-0.5, 0.5]`` and leave as
uint8 via a truncating cast of ``(x + 0.5) * 255``.
"""

from __future__ import annotations

import torch


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
