"""Temporal output stabilization (frame moving average) with scene-change
detection.

Port of ``joshupscale_tpu/ops/temporal.py``, applied between the
generator output and the recurrent state:

    diff   = norm(gen - pre_warp)            (L1 abs or L2 square)
    mean   = global mean | strided window means
    cond   = sign(mean - threshold)          (gain=0)
             tanh(gain * (mean - threshold)) (gain>0, soft)
    mask   = strength * (1 - cond) / 2       (in [0, strength])
    output = pre_warp * mask + gen * (1 - mask)

With window > 0 the decision is local: per-window means, upscaled back
bilinearly on the TF1 legacy grid.  The channel weights are scalars, so
no host data enters the step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.ops.image import BGR_LUMA
from joshupscale_torch.ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class FrameMovingAvgConfig:
    strength: float = 0.7
    window: int = 0          # 0 = global scene detection
    threshold: float = 0.1
    gain: float = 0.0        # 0 = hard sign gate, >0 = tanh soft gate
    norm: str = "l1"         # "l1" | "l2"
    limit: bool = False      # clamp pre_warp to [-0.5, 0.5] first
    luma_normalize: bool = False


def _channel_weights(cfg: FrameMovingAvgConfig, gain_coef: float):
    """The per-channel weights of ``diff``, float32 as the reference
    computes them."""
    luma = np.asarray(BGR_LUMA, np.float32) * 3.0
    if cfg.luma_normalize:
        weights = luma * gain_coef
        if cfg.norm == "l2":
            weights = weights * luma
    else:
        weights = np.full((3,), gain_coef, np.float32)
    return weights.astype(np.float32)


def _weighted_channel_sum(diff: torch.Tensor, weights) -> torch.Tensor:
    """sum_c diff[..., c] * weights[c], float32 -> (N, H, W)."""
    return sum(diff[..., c] * float(weights[c]) for c in range(3))


def frame_moving_avg(gen: torch.Tensor, pre_warp: torch.Tensor,
                     config: FrameMovingAvgConfig) -> torch.Tensor:
    """Blend ``gen`` (N, H, W, 3) with ``pre_warp`` unless a scene cut."""
    cfg = config
    dtype = gen.dtype
    n, h, w, _ = gen.shape

    warp = pre_warp.to(dtype)
    if cfg.limit:
        warp = torch.clamp(warp, -0.5, 0.5)

    diff = (gen - warp).float()
    if cfg.norm == "l1":
        diff = diff.abs()
    elif cfg.norm == "l2":
        diff = diff * diff
    else:
        raise ValueError(f"Unknown norm type {cfg.norm}")

    gain_coef = 1.0 if cfg.gain == 0 else float(cfg.gain)
    weights = _channel_weights(cfg, gain_coef)
    if cfg.window == 0:
        # Mean over all elements of w_c * diff (the reference multiplies
        # the weights in before its ReduceMean).
        total = _weighted_channel_sum(diff, weights).sum(dim=(1, 2))
        mean = (total / (h * w * 3)).view(n, 1, 1, 1)
        cond = _gate(mean, cfg, gain_coef)
    else:
        win = int(cfg.window)
        ph = (h + win - 1) // win * win
        pw = (w + win - 1) // win * win
        pad_t = (ph - h) // 2
        pad_l = (pw - w) // 2
        diff = F.pad(diff, (0, 0, pad_l, pw - w - pad_l,
                            pad_t, ph - h - pad_t))
        # Per-window mean of w_c * diff over window*window*3 values.
        scaled = (weights / np.float32(3.0 * win * win)).astype(np.float32)
        mean = _weighted_channel_sum(diff, scaled).view(
            n, ph // win, win, pw // win, win).sum(dim=(2, 4))[..., None]
        cond = _gate(mean, cfg, gain_coef)
        # Upscale back on the asymmetric (TF1 legacy) grid, then crop
        # the padding off.
        cond = resize_bilinear(cond, ph, pw)
        cond = cond[:, pad_t:pad_t + h, pad_l:pad_l + w, :]
    mask = (cfg.strength * (1.0 - cond) / 2.0).to(dtype)
    return warp * mask + gen * (1.0 - mask)


def _gate(mean: torch.Tensor, cfg: FrameMovingAvgConfig,
          gain_coef: float) -> torch.Tensor:
    shifted = mean - float(np.float32(cfg.threshold * gain_coef))
    if cfg.gain == 0:
        return torch.sign(shifted)
    return torch.tanh(shifted)
