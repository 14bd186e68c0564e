"""Tensor ops of the serving path (NHWC, PyTorch)."""

from joshupscale_torch.ops.image import brightness, postprocess, preprocess
from joshupscale_torch.ops.resize import (
    resize_bilinear,
    resize_nearest,
    upscale_bilinear,
    upscale_nearest,
)
from joshupscale_torch.ops.space_depth import depth_to_space, space_to_depth
from joshupscale_torch.ops.temporal import (
    FrameMovingAvgConfig,
    frame_moving_avg,
)
from joshupscale_torch.ops.warp import dense_image_warp, dense_image_warp_s2d

__all__ = [
    "FrameMovingAvgConfig",
    "brightness",
    "dense_image_warp",
    "dense_image_warp_s2d",
    "depth_to_space",
    "frame_moving_avg",
    "postprocess",
    "preprocess",
    "resize_bilinear",
    "resize_nearest",
    "space_to_depth",
    "upscale_bilinear",
    "upscale_nearest",
]
