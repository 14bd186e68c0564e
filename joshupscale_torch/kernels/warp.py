"""K3: the s2d dense warp (bilinear, tfa edge clamp) in one launch.

Source note.  Replaces no TPU kernel: ``joshupscale_tpu/ops/warp.py``
``dense_image_warp_s2d`` is plain XLA on the TPU, since Mosaic has no
in-kernel dynamic gather.  The port ran it as torch ops
(``ops/warp.py dense_image_warp_s2d_plain``: a 75-lane corner table
built by three ``cat``s, a row gather, a corner-major copy and a
25-term combine, 3.5 ms a frame at 270x480 on an H100), of which 21
terms add exact zeros.  The CUDA source is
``joshupscale_torch/csrc/warp_s2d.cu``: one thread an output pixel reads
its two flow values and the four live corners straight from the s2d
image and sums them with the plain path's roundings in its order, so
the result is bit-exact with it.  At (1, 270, 480, 48) bf16 it reads
8.3 MB of flow and 12.4 MB of image and writes 12.4 MB, 9.9 us at
3.35 TB/s (the corner reads hit L2, which holds the whole image), but
its instruction count, about 200 a thread, bounds it at 26-27 us on an
H100.

``warp_s2d`` launches the kernel for CUDA tensors through the registered
op ``torch.ops.joshupscale.warp_s2d`` (``csrc/torch_ops.cpp``, which
makes a contiguous image and a flow with unit channel stride where they
are not), so ``torch.export`` traces it and an AOTInductor package calls
it; it runs the plain version for CPU tensors.  ``ops/warp.py``
``dense_image_warp_s2d`` calls it where ``takes`` holds.
``warp_s2d.launches`` counts kernel launches (not traces under
``torch.export``).
"""

from __future__ import annotations

import torch

from joshupscale_torch.kernels import _build

IMAGE_DTYPES = (torch.float32, torch.bfloat16, torch.uint8)
FLOW_DTYPES = (torch.float32, torch.bfloat16)
BLOCK = 4
CHANNELS = 3


def takes(image_s2d: torch.Tensor, flow_s2d: torch.Tensor,
          block: int) -> bool:
    """Whether the kernel serves ``dense_image_warp_s2d(image_s2d,
    flow_s2d, block)``: CUDA tensors, block 4, an RGB image in a type it
    reads and no gradient to take (the plain gather's backward sums the
    table's gradient)."""
    return (image_s2d.device.type == "cuda" and block == BLOCK
            and image_s2d.dim() == 4 and flow_s2d.dim() == 4
            and image_s2d.shape[-1] == BLOCK * BLOCK * CHANNELS
            and flow_s2d.shape[-1] == BLOCK * BLOCK * 2
            and image_s2d.dtype in IMAGE_DTYPES
            and flow_s2d.dtype in FLOW_DTYPES
            and not (torch.is_grad_enabled()
                     and (image_s2d.requires_grad
                          or flow_s2d.requires_grad)))


def warp_s2d(image_s2d: torch.Tensor, flow_s2d: torch.Tensor,
             row0: int = 0) -> torch.Tensor:
    """(N, Hb, Wb, 48) s2d image warped by the (N, Hq, Wb, 32) s2d flow
    of block rows ``[row0, row0 + Hq)``: (N, Hq, Wb, 48), float32 for a
    float32 image, else bfloat16 (a uint8 image dequantized as
    ``acc / 255 - 0.5``).  CUDA tensors run the kernel (the op raises
    ``ValueError`` / ``TypeError`` on shapes and types it does not
    take), CPU tensors the plain version."""
    if image_s2d.device.type == "cpu":
        from joshupscale_torch.ops.warp import dense_image_warp_s2d_plain

        return dense_image_warp_s2d_plain(image_s2d, flow_s2d, BLOCK, row0)
    if image_s2d.device.type != "cuda":
        raise ValueError(f"unsupported device {image_s2d.device}")
    out = _build.ops().warp_s2d(image_s2d, flow_s2d, int(row0))
    if not _build.tracing(out):
        warp_s2d.launches += 1
    return out


warp_s2d.launches = 0
