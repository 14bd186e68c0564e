"""Dense image warp, pixel and space-to-depth forms, tfa edge-clamp
semantics.

Port of ``dense_image_warp``, ``dense_image_warp_s2d`` and
``dense_image_warp_via_s2d`` from ``joshupscale_tpu/ops/warp.py`` (the
s2d form on a float or u8 table):

    output[b, y, x, c] = bilinear_sample(image, (y - flow_y, x - flow_x))

The floor corner is clamped to ``[0, size - 2]`` and the interpolation
weight to ``[0, 1]``, so queries outside the image reproduce the nearest
edge pixel.  ``row0`` serves a row slab of the output (``SpatialEngine``):
the flow holds rows ``[row0, row0 + rows)`` of the image's grid, the
queries use those global rows and the whole image is read, so each
output pixel is the same function of its own query either way.  Index
math stays in float32: bfloat16 cannot represent
pixel coordinates above 256 exactly.  ``grid_sample`` is not used: its
normalised coordinates do not give this grid.

Both forms are differentiable in the image and the flow, as the
reference's training warps are.  The weights' clip passes the
reference's gradient at its bounds (``ops.image.clip``), and the s2d
gather of a table that requires grad sums the table's gradient in
float32 (``_SegsumGather``, the reference's ``_segsum_gather``).

Where each path runs: on the card, ``dense_image_warp_s2d`` without a
gradient to take launches one hand-written kernel (K3,
``kernels/warp.py``, ``csrc/warp_s2d.cu``), bit-exact with the plain
torch ops of ``dense_image_warp_s2d_plain`` (one row gather of a corner
table, then the bilinear blend), which run on the CPU, under autograd
(training's ``dense_image_warp_via_s2d``) and for inputs the kernel
does not take.  The pixel form ``dense_image_warp`` is plain torch ops
everywhere.
"""

from __future__ import annotations

import torch

from joshupscale_torch.kernels import warp as _kernel
from joshupscale_torch.ops.image import clip
from joshupscale_torch.ops.space_depth import depth_to_space, space_to_depth


def _floor_and_alpha(q: torch.Tensor, size: int):
    """Clamped floor index (int64) and interpolation weight (float32) of
    float32 query coordinates along an axis of ``size``."""
    f = torch.clamp(torch.floor(q), 0.0, float(size - 2))
    return f.to(torch.int64), clip(q - f, 0.0, 1.0)


class _SegsumGather(torch.autograd.Function):
    """Row gather ``table[idx]`` whose table gradient is summed in
    float32 and cast to the table's dtype at the end, as the
    reference's ``_segsum_gather`` (``joshupscale_tpu/ops/warp.py``)
    sums its one-hot product: an ``index_add_`` straight into a bf16
    gradient would round every partial sum.  The indices are in bounds
    by construction (the warp clamps its floor corners), so the
    reference's fill-mode clip changes nothing.  On the card the adds
    are atomic, so the summation order, and a float32 sum's last bits,
    may change from run to run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=grad.device)
        acc.index_add_(0, idx, grad.float())
        return acc.to(ctx.table_dtype), None


def dense_image_warp(image: torch.Tensor, flow: torch.Tensor,
                     row0: int = 0) -> torch.Tensor:
    """Warp a pixel-form image by a per-pixel flow.

    image: (N, H, W, C) float; flow: (N, Hq, W, 2), channel 0 the y
    offset, 1 the x offset, for output rows ``[row0, row0 + Hq)`` (the
    whole frame by default).  The four corners come from one gather of
    ``4C``-lane rows ``[p, p+x1, p+y1, p+x1y1]`` built from edge-clamped
    shifts; the blend runs in ``image.dtype``.
    """
    n, h, w, c = image.shape
    hq = flow.shape[1]
    dev = image.device
    out_dtype = image.dtype
    flow32 = flow.to(torch.float32)
    qy = torch.arange(row0, row0 + hq, device=dev,
                      dtype=torch.float32).view(1, hq, 1) - flow32[..., 0]
    qx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) \
        - flow32[..., 1]
    iy, ay = _floor_and_alpha(qy, h)
    ix, ax = _floor_and_alpha(qx, w)

    img_x1 = torch.cat([image[:, :, 1:], image[:, :, -1:]], dim=2)
    img_y1 = torch.cat([image[:, 1:], image[:, -1:]], dim=1)
    img_xy = torch.cat([img_y1[:, :, 1:], img_y1[:, :, -1:]], dim=2)
    corners = torch.cat([image, img_x1, img_y1, img_xy], dim=-1)

    lin = iy * w + ix
    if n > 1:
        lin = lin + (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1)
    rows = corners.reshape(n * h * w, 4 * c)[lin.reshape(-1)]
    rows = rows.reshape(n, hq, w, 4, c)

    ay = ay[..., None].to(out_dtype)
    ax = ax[..., None].to(out_dtype)
    tl, tr, bl, br = rows.unbind(dim=3)
    top = tl + (tr - tl) * ax
    bot = bl + (br - bl) * ax
    return top + (bot - top) * ay


def dense_image_warp_s2d(image_s2d: torch.Tensor, flow_s2d: torch.Tensor,
                         block: int = 4, row0: int = 0) -> torch.Tensor:
    """Warp an s2d image by an s2d flow (arguments and result as
    ``dense_image_warp_s2d_plain``): the kernel where it takes the
    inputs (``kernels.warp.takes``: CUDA, block 4, an RGB float or u8
    image, no gradient to take), else the plain torch ops; both give the
    same values, bit for bit."""
    if _kernel.takes(image_s2d, flow_s2d, block):
        return _kernel.warp_s2d(image_s2d, flow_s2d, row0)
    return dense_image_warp_s2d_plain(image_s2d, flow_s2d, block, row0)


def dense_image_warp_s2d_plain(image_s2d: torch.Tensor,
                               flow_s2d: torch.Tensor, block: int = 4,
                               row0: int = 0) -> torch.Tensor:
    """Warp an s2d image by an s2d flow, in plain torch ops.

    Parameters
    ----------
    image_s2d : (N, Hb, Wb, B*B*C) s2d-form image (channel order
        ``(ry, rx, c)`` like ``tf.nn.space_to_depth``), float, or uint8
        (the u8-state tier: the gathered u8 rows become bfloat16, the
        combine runs in bfloat16 on the raw 0..255 values, and one
        float32 affine ``acc/255 - 0.5`` maps back, exact because the
        bilinear weights sum to 1).
    flow_s2d : (N, Hq, Wb, B*B*2) s2d-form flow (the flow net's head
        output before its depth_to_space; channel ``(ry, rx, {y, x})``)
        of the block rows ``[row0, row0 + Hq)`` (all of them by default).

    Returns
    -------
    (N, Hq, Wb, B*B*C) warped image in s2d form, in ``image_s2d``'s
    dtype (bfloat16 for a uint8 image).
    """
    n, hb, wb, cs = image_s2d.shape
    hq = flow_s2d.shape[1]
    b = block
    p2 = b * b
    c = cs // p2
    h, w = hb * b, wb * b
    dev = image_s2d.device
    u8 = image_s2d.dtype == torch.uint8
    out_dtype = torch.bfloat16 if u8 else image_s2d.dtype

    # Table row = the (b+1)^2 corner subpositions one output pixel can
    # touch: base block (b*b*c lanes) + the x-neighbour's first column
    # (b*c) + the y-neighbour's first row (b*c) + the xy corner (c).
    def corner_lane(sy: int, sx: int) -> int:
        if sy < b and sx < b:
            return (sy * b + sx) * c
        if sy < b:  # sx == b: x-neighbour column
            return p2 * c + sy * c
        if sx < b:  # sy == b: y-neighbour row
            return p2 * c + b * c + sx * c
        return p2 * c + 2 * b * c

    # ---- query coordinates per (block, phase), float32 ------------------
    flow32 = flow_s2d.to(torch.float32)
    fy_flow = flow32[..., 0::2]  # (N, Hb, Wb, 16), phase-major
    fx_flow = flow32[..., 1::2]
    phase = torch.arange(p2, device=dev)
    py_off = (phase // b).to(torch.float32)
    px_off = (phase % b).to(torch.float32)
    by = torch.arange(row0, row0 + hq, device=dev,
                      dtype=torch.float32).view(1, hq, 1, 1)
    bx = torch.arange(wb, device=dev, dtype=torch.float32).view(1, 1, wb, 1)
    iy, ay = _floor_and_alpha(by * b + py_off - fy_flow, h)
    ix, ax = _floor_and_alpha(bx * b + px_off - fx_flow, w)
    ay = ay.to(out_dtype)[..., None]
    ax = ax.to(out_dtype)[..., None]

    # ---- corner-subposition table: [S | S>x col0 | S>y row0 | S>xy c] ---
    sx_img = torch.cat([image_s2d[:, :, 1:], image_s2d[:, :, -1:]], dim=2)
    sy_img = torch.cat([image_s2d[:, 1:], image_s2d[:, -1:]], dim=1)
    sxy_img = torch.cat([sy_img[:, :, 1:], sy_img[:, :, -1:]], dim=2)
    xcol = sx_img.reshape(n, hb, wb, b, b, c)[:, :, :, :, 0, :].reshape(
        n, hb, wb, b * c)
    yrow = sy_img[..., : b * c]
    xy = sxy_img[..., :c]
    table = torch.cat([image_s2d, xcol, yrow, xy], dim=-1)
    lanes = (b + 1) * (b + 1) * c

    # ---- one row gather per output phase (indices in bounds) -----------
    lin = (iy // b) * wb + ix // b
    if n > 1:
        lin = lin + (torch.arange(n, device=dev) * (hb * wb)).view(
            n, 1, 1, 1)
    flat = table.reshape(n * hb * wb, lanes)
    if flat.requires_grad:
        rows = _SegsumGather.apply(flat, lin.reshape(-1))
    else:
        rows = flat[lin.reshape(-1)]
    # Corner-major copy: each sub-position's c lanes become one dense
    # (N, Hb, Wb, 16, c) slab, so the combine below multiplies dense
    # tensors instead of strided lane slices (same values, same order).
    slabs = rows.reshape(n, hq, wb, p2, lanes // c, c).permute(
        4, 0, 1, 2, 3, 5).to(out_dtype).contiguous()

    # ---- separable combine over the 5x5 possible corner offsets ---------
    # Corner (dy, dx) sits at sub-position (iy % b + dy, ix % b + dx);
    # its lane is a static function of that position (corner_lane) and
    # its weight is wy[sy] * wx[sx] with
    # wy[sy] = (1-ay)*[py == sy] + ay*[py == sy - 1].
    py = (iy % b)[..., None]
    px = (ix % b)[..., None]
    wxs = [((1.0 - ax) * (px == sx) + ax * (px == sx - 1)).to(out_dtype)
           for sx in range(b + 1)]
    acc = torch.zeros((n, hq, wb, p2, c), dtype=out_dtype, device=dev)
    for sy in range(b + 1):
        wy = ((1.0 - ay) * (py == sy) + ay * (py == sy - 1)).to(out_dtype)
        for sx in range(b + 1):
            slab = slabs[corner_lane(sy, sx) // c]
            acc = acc + slab * (wy * wxs[sx])
    if u8:
        acc = (acc.float() * (1.0 / 255.0) - 0.5).to(out_dtype)
    return acc.reshape(n, hq, wb, p2 * c)


def dense_image_warp_via_s2d(image: torch.Tensor, flow: torch.Tensor,
                             block: int = 4) -> torch.Tensor:
    """A pixel-form warp computed in s2d form: ``space_to_depth`` of the
    image and the flow, ``dense_image_warp_s2d``, ``depth_to_space``.
    The same values as ``dense_image_warp``, differentiable in both
    inputs; the training recurrence's warp (the reference's
    ``s2d_scan_warp``).  H or W not divisible by ``block`` falls back to
    the pixel form, as in the reference."""
    _, h, w, _ = image.shape
    if h % block or w % block:
        return dense_image_warp(image, flow)
    out = dense_image_warp_s2d(space_to_depth(image, block),
                               space_to_depth(flow, block), block)
    return depth_to_space(out, block)
