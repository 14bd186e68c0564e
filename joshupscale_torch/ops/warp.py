"""Dense image warp in space-to-depth form, tfa edge-clamp semantics.

Port of ``dense_image_warp_s2d`` from ``joshupscale_tpu/ops/warp.py``
(float table, ``gather_mode="promise"`` semantics):

    output[b, y, x, c] = bilinear_sample(image, (y - flow_y, x - flow_x))

computed on s2d-form tensors.  The floor corner is clamped to
``[0, size - 2]`` and the interpolation weight to ``[0, 1]``, so queries
outside the image reproduce the nearest edge pixel.  Index math stays in
float32: bfloat16 cannot represent pixel coordinates above 256 exactly.
``grid_sample`` is not used: its normalised coordinates do not give this
grid.

Plain torch ops for now (one row gather from the 75-lane
corner-subposition table, then the separable 5x5 combine); a Hopper
kernel for the gather + combine is queued in ROADMAP.md.
"""

from __future__ import annotations

import torch


def dense_image_warp_s2d(image_s2d: torch.Tensor, flow_s2d: torch.Tensor,
                         block: int = 4) -> torch.Tensor:
    """Warp an s2d image by an s2d flow.

    Parameters
    ----------
    image_s2d : (N, Hb, Wb, B*B*C) s2d-form float image (channel order
        ``(ry, rx, c)`` like ``tf.nn.space_to_depth``).
    flow_s2d : (N, Hb, Wb, B*B*2) s2d-form flow (the flow net's head
        output before its depth_to_space; channel ``(ry, rx, {y, x})``).

    Returns
    -------
    (N, Hb, Wb, B*B*C) warped image in s2d form, dtype of ``image_s2d``.
    """
    if not image_s2d.is_floating_point():
        raise NotImplementedError(
            "the u8-table warp (u8_state) is not ported yet; it waits "
            "for the deployment-variants slice")
    n, hb, wb, cs = image_s2d.shape
    b = block
    p2 = b * b
    c = cs // p2
    h, w = hb * b, wb * b
    dev = image_s2d.device
    out_dtype = image_s2d.dtype

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
    by = torch.arange(hb, device=dev, dtype=torch.float32).view(1, hb, 1, 1)
    bx = torch.arange(wb, device=dev, dtype=torch.float32).view(1, 1, wb, 1)
    qy = by * b + py_off - fy_flow
    qx = bx * b + px_off - fx_flow

    fy = torch.clamp(torch.floor(qy), 0.0, float(h - 2))
    fx = torch.clamp(torch.floor(qx), 0.0, float(w - 2))
    iy = fy.to(torch.int64)
    ix = fx.to(torch.int64)
    ay = torch.clamp(qy - fy, 0.0, 1.0).to(out_dtype)[..., None]
    ax = torch.clamp(qx - fx, 0.0, 1.0).to(out_dtype)[..., None]

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
    rows = table.reshape(n * hb * wb, lanes)[lin.reshape(-1)]
    # Corner-major copy: each sub-position's c lanes become one dense
    # (N, Hb, Wb, 16, c) slab, so the combine below multiplies dense
    # tensors instead of strided lane slices (same values, same order).
    slabs = rows.reshape(n, hb, wb, p2, lanes // c, c).permute(
        4, 0, 1, 2, 3, 5).contiguous()

    # ---- separable combine over the 5x5 possible corner offsets ---------
    # Corner (dy, dx) sits at sub-position (iy % b + dy, ix % b + dx);
    # its lane is a static function of that position (corner_lane) and
    # its weight is wy[sy] * wx[sx] with
    # wy[sy] = (1-ay)*[py == sy] + ay*[py == sy - 1].
    py = (iy % b)[..., None]
    px = (ix % b)[..., None]
    wxs = [((1.0 - ax) * (px == sx) + ax * (px == sx - 1)).to(out_dtype)
           for sx in range(b + 1)]
    acc = torch.zeros((n, hb, wb, p2, c), dtype=out_dtype, device=dev)
    for sy in range(b + 1):
        wy = ((1.0 - ay) * (py == sy) + ay * (py == sy - 1)).to(out_dtype)
        for sx in range(b + 1):
            slab = slabs[corner_lane(sy, sx) // c]
            acc = acc + slab * (wy * wxs[sx])
    return acc.reshape(n, hb, wb, p2 * c)
