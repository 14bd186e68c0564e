"""PyTorch/CUDA port of the recurrent x4 video upscaler.

A second package beside ``joshupscale_tpu`` (the JAX reference).  Module
paths and function names mirror the reference so each counterpart is
easy to find: ``joshupscale_torch/ops/warp.py`` <->
``joshupscale_tpu/ops/warp.py`` and so on.  Public functions take and
return NHWC tensors, like the reference.

This package imports ``torch`` and ``numpy`` only (``yaml`` lazily, in
the package loader).  The hot-path kernels are hand-written CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` at first use
(``kernels/_build.py``); each has a plain PyTorch version that runs for
CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[None, int, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the (first) CUDA device; an int is a CUDA device
    index.  Asking for CUDA where none is present raises: entry points
    never drop to the CPU unless the caller names it.
    """
    if device is None:
        device = "cuda"
    elif isinstance(device, int):
        device = f"cuda:{device}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            f"pass device='cpu' to run the plain PyTorch versions")
    return dev
