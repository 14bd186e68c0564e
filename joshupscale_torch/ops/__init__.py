"""Tensor ops of the serving path (NHWC, PyTorch)."""

from joshupscale_torch.ops.image import postprocess, preprocess
from joshupscale_torch.ops.resize import upscale_bilinear
from joshupscale_torch.ops.space_depth import depth_to_space, space_to_depth
from joshupscale_torch.ops.warp import dense_image_warp_s2d

__all__ = [
    "dense_image_warp_s2d",
    "depth_to_space",
    "postprocess",
    "preprocess",
    "space_to_depth",
    "upscale_bilinear",
]
