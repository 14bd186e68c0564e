"""K1: the fused res-block conv (3x3 conv + folded BN + residual + act).

Source note.  Replaces the TPU kernel
``joshupscale_tpu/nn/resblock_pallas.py:_conv_kernel`` (built by
``_build_conv_call``, driven by ``res_block_chain``).  The CUDA source is
``joshupscale_torch/csrc/resblock_conv.cu`` on the Hopper core of
``csrc/wgmma_tma.cuh``.  At the main path's shape, (1, 270, 480, 64)
bf16, the card's bound is about 10 us (operations, and the bytes of
conv_1) to 15 us (the bytes of conv_2, which adds a residual) per
launch, so the reduction must run on the tensor cores at full rate while
every activation byte moves once.  For bf16 the kernel is an implicit
GEMM on ``wgmma`` (M = pixels, N = C output channels, K = 9 taps x C):
TMA brings each 8 x 16-pixel tile's input halo and residual into shared
memory (SAME padding and ragged edges are TMA's zero fill), a tap is
only a shift of the ``wgmma`` descriptor into the halo (no patch is
built), the weights stay resident, two warpgroups take turns so one's
epilogue overlaps the other's products, and a TMA store writes the tile
back.  For f32 it is a direct CUDA-core conv.  The Pallas kernel's flat
pad ring, column mask and persistent ring scratch served the TPU's
sequential grid and VMEM; here they are TMA's zero fill and an mbarrier
ring.  TMA takes operands whose base addresses are multiples of 16
bytes, which the wrapper checks.

``resblock_conv3x3`` launches the kernel for CUDA tensors and runs
``resblock_conv3x3_plain`` for CPU tensors; there is no fallback from
one to the other.  ``resblock_conv3x3.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from joshupscale_torch.kernels import _build

SUPPORTED_CHANNELS = (32, 48, 64)
_ACT_CODES = {"relu": 0, "lrelu": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("resblock_conv")
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        lib.jt_resblock_conv3x3.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
            ctypes.c_float, vp]
        lib.jt_resblock_conv3x3.restype = ci
        _lib = lib
    return _lib


def _act(y: torch.Tensor, act: str, alpha: float) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    return torch.where(y >= 0, y, y * alpha)


def resblock_conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                           scale: torch.Tensor, offset: torch.Tensor,
                           residual: Optional[torch.Tensor] = None,
                           act: str = "relu",
                           alpha: float = 0.3) -> torch.Tensor:
    """The plain PyTorch version: the same arithmetic as the kernel.

    Conv in float32 on the (exactly widened) inputs, epilogue in float32,
    one rounding to ``x.dtype``.
    """
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(0, 3, 1, 2).float(), padding=1)
    y = y.permute(0, 2, 3, 1) * scale.float() + offset.float()
    if residual is not None:
        y = y + residual.float()
    return _act(y, act, alpha).to(x.dtype).contiguous()


def _check_args(x, w, scale, offset, residual, act):
    if act not in _ACT_CODES:
        raise ValueError(f"activation must be relu or lrelu, got {act!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (4-D), got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(
            f"res-block conv supports C in {SUPPORTED_CHANNELS}, got {c}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if tuple(w.shape) != (c, 3, 3, c) or w.dtype != x.dtype:
        raise ValueError(
            f"w must be OHWI {(c, 3, 3, c)} in {x.dtype}, got "
            f"{tuple(w.shape)} {w.dtype}")
    for name, t in (("scale", scale), ("offset", offset)):
        if tuple(t.shape) != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({c},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("residual must match x in shape and dtype")
    tensors = [x, w, scale, offset] + ([residual] if residual is not None
                                       else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    return tensors


def resblock_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     offset: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     act: str = "relu", alpha: float = 0.3) -> torch.Tensor:
    """``act(conv3x3_SAME(x, w) * scale + offset [+ residual])``.

    x: (N, H, W, C) NHWC, C in {32, 48, 64}, float32 or bfloat16;
    w: OHWI (C, 3, 3, C) in x's dtype; scale, offset: float32 (C,);
    residual: like x or None.  CUDA tensors run the kernel, CPU tensors
    the plain version.
    """
    tensors = _check_args(x, w, scale, offset, residual, act)
    if x.device.type == "cpu":
        return resblock_conv3x3_plain(x, w, scale, offset, residual, act,
                                      alpha)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte "
                             "aligned")
    n, h, wd, c = x.shape
    y = torch.empty_like(x)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.jt_resblock_conv3x3(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            scale.data_ptr(), offset.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), n, h, wd, c, _ACT_CODES[act], float(alpha),
            stream)
    _build.check(lib, err, "resblock_conv3x3 launch")
    resblock_conv3x3.launches += 1
    return y


resblock_conv3x3.launches = 0
