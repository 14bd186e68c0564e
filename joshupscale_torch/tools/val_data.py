"""What the calibration tools share: the rendered validation sequences
(``<data>/val/{lr,hr}/*.png``, ten-frame groups), PSNR, and the two
resnet architectures they build.  The port's copy of
``tools/eval_synth.py``'s ``load_sequences`` and ``psnr``."""

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
