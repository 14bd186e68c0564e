"""What the calibration and quality tools share: the rendered validation
sequences (``<data>/val/{lr,hr}/*.png``, ten-frame groups), PSNR, the
bilinear x4 baseline and the two resnet architectures they build.  The
port's copy of ``tools/eval_synth.py``'s ``load_sequences`` and
``psnr``."""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

# (filters, res blocks) of the flow net and the generator.
ARCHS = {"quality": ((64, 10), (64, 24)), "fast": ((32, 6), (48, 12))}


def load_sequences(data_dir: str):
    """(LR, HR) u8 BGR frames of ``data_dir/val``, as (N, 10, H, W, 3)
    and (N, 10, 4H, 4W, 3)."""
    import cv2

    lr_files = sorted(glob.glob(os.path.join(data_dir, "val/lr/*.png")))
    hr_files = sorted(glob.glob(os.path.join(data_dir, "val/hr/*.png")))
    if not lr_files or len(lr_files) != len(hr_files):
        raise ValueError(f"no rendered val set (matching lr/hr PNGs) under "
                         f"{data_dir}/val")
    lr = np.stack([cv2.imread(p, cv2.IMREAD_COLOR) for p in lr_files])
    hr = np.stack([cv2.imread(p, cv2.IMREAD_COLOR) for p in hr_files])
    return (lr.reshape(-1, 10, *lr.shape[1:]),
            hr.reshape(-1, 10, *hr.shape[1:]))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) / 255.0
                   - b.astype(np.float64) / 255.0) ** 2)
    return float(-10.0 * np.log10(mse))


def report_psnrs(text: str):
    """(model, bilinear) PSNR dB from the report ``eval_synth`` or
    ``eval_serving_fullres`` prints."""
    import re

    found = dict(re.findall(r"(model|bilinear) +PSNR: (-?[0-9.]+) dB",
                            text))
    return float(found["model"]), float(found["bilinear"])


def bilinear_x4_u8(lr: np.ndarray, device) -> np.ndarray:
    """The no-model baseline: u8 frames (..., H, W, 3) upscaled x4 by
    the TF1 bilinear grid (the generator's skip), float32 on ``device``
    without TF32, back to u8 as the reference's tools round it."""
    import torch

    from joshupscale_torch.ops.resize import upscale_bilinear
    from joshupscale_torch.training.trainer import exact_float32

    lead, (h, w) = lr.shape[:-3], lr.shape[-3:-1]
    x = lr.reshape(-1, h, w, 3).astype(np.float32) / 255.0 - 0.5
    with exact_float32():
        up = upscale_bilinear(torch.from_numpy(x).to(device), 4)
    up = np.clip((up.cpu().numpy() + 0.5) * 255.0, 0, 255).astype(np.uint8)
    return up.reshape(*lead, 4 * h, 4 * w, 3)


def arch_config(arch: str, h: int, w: int,
                compute_dtype: Optional[str] = None) -> dict:
    """The registry config of an inference model of ``ARCHS[arch]`` at
    ``h`` x ``w`` with u8 frames in and out."""
    (flow_f, flow_b), (gen_f, gen_b) = ARCHS[arch]
    inference = {"name": "inference", "generator": {"model": "generator"},
                 "flow": {"model": "flow"}, "skip_processing": False,
                 "frame_height": h, "frame_width": w}
    if compute_dtype:
        inference["compute_dtype"] = compute_dtype
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": flow_f, "num_res_blocks": flow_b},
        "generator": {"name": "generator-resnet", "num_filters": gen_f,
                      "num_res_blocks": gen_b},
        "inference": inference,
    }
