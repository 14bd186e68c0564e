"""K2: fused depth_to_space(4) + uint8 display conversion.

Source note.  Replaces the TPU kernel
``joshupscale_tpu/ops/display.py:_kernel`` (driven by
``d2s_display_u8``).  The CUDA source is
``joshupscale_torch/csrc/display_u8.cu``.  It is bound by bytes: at
(1, 270, 480, 48) bf16 it reads 12.4 MB and writes 6.2 MB, about 5.6 us
at 3.35 TB/s.  One thread per (input pixel, output row phase) reads 12
contiguous values with vector loads and writes 12 contiguous output
bytes as three 32-bit words; the add and multiply are separately
rounded and the conversion truncates, so the result is bit-exact with
the plain version.

``d2s_display_u8`` launches the kernel for CUDA tensors and runs
``d2s_display_u8_plain`` for CPU tensors; ``d2s_display_u8.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from joshupscale_torch.kernels import _build
from joshupscale_torch.ops.image import postprocess
from joshupscale_torch.ops.space_depth import depth_to_space

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("display_u8")
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.jt_d2s_display_u8.argtypes = [ci, vp, vp, ci, ci, ci, vp]
        lib.jt_d2s_display_u8.restype = ci
        _lib = lib
    return _lib


def d2s_display_u8_plain(x_s2d: torch.Tensor, block: int = 4) -> torch.Tensor:
    """The plain PyTorch version: ``postprocess(depth_to_space(x, b))``."""
    return postprocess(depth_to_space(x_s2d, block))


def d2s_display_u8(x_s2d: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(N, Hb, Wb, 48) float s2d -> (N, 4Hb, 4Wb, 3) uint8.

    Also takes the stacked clip form (T, N, Hb, Wb, 48) and returns
    (T, N, 4Hb, 4Wb, 3).
    """
    if x_s2d.dim() == 5:
        t, n = x_s2d.shape[:2]
        out = d2s_display_u8(x_s2d.reshape((t * n,) + x_s2d.shape[2:]),
                             block)
        return out.reshape((t, n) + out.shape[1:])
    if x_s2d.dim() != 4:
        raise ValueError(f"expected (N, Hb, Wb, C) or (T, N, Hb, Wb, C), "
                         f"got {tuple(x_s2d.shape)}")
    if block != 4 or x_s2d.shape[-1] != 48:
        raise ValueError(f"d2s_display_u8 takes block 4 and 48 channels, "
                         f"got block {block}, {x_s2d.shape[-1]} channels")
    if x_s2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x_s2d.dtype}")
    if x_s2d.device.type == "cpu":
        return d2s_display_u8_plain(x_s2d, block)
    if x_s2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x_s2d.device}")
    if not x_s2d.is_contiguous() or x_s2d.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    n, hb, wb, _ = x_s2d.shape
    out = torch.empty((n, hb * 4, wb * 4, 3), dtype=torch.uint8,
                      device=x_s2d.device)
    lib = _kernel_lib()
    with torch.cuda.device(x_s2d.device):
        stream = torch.cuda.current_stream(x_s2d.device).cuda_stream
        err = lib.jt_d2s_display_u8(_DTYPE_CODES[x_s2d.dtype],
                                    x_s2d.data_ptr(), out.data_ptr(), n, hb,
                                    wb, stream)
    _build.check(lib, err, "d2s_display_u8 launch")
    d2s_display_u8.launches += 1
    return out


d2s_display_u8.launches = 0
