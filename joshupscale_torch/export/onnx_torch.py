"""Torch-backed executor for the exported ONNX deployment graph.

Port of ``joshupscale_tpu/export/onnx_torch.py``, with a ``device``:
like every entry point of the port it runs on the CUDA device unless the
caller asks for the CPU.  It runs the graphs written by
:mod:`joshupscale_torch.export.onnx_export` through torch's op
implementations; the ops whose semantics are subtle map so:

- ``GridSample`` -> ``torch.nn.functional.grid_sample`` (the ONNX op
  was specified after torch's; ``bilinear``/``border``/
  ``align_corners=0`` map 1:1), the replace_dense_warp contract
  (reference ``scripts/inference/onnx/replace_dense_warp.py:70-112``);
- ``Conv``/``ConvTranspose`` -> ``conv2d``/``conv_transpose2d``
  (OIHW / IOHW weight layouts are torch's native conventions), float32
  without TF32;
- ``DepthToSpace(DCR)``/``SpaceToDepth`` per the ONNX spec formulas
  (torch's ``pixel_shuffle`` is CRD, so these are explicit permutes).

``Resize`` (``linear`` + ``asymmetric``) has no torch equivalent
(torch only implements half-pixel/align-corners grids), so it is the
one op re-implemented here with torch indexing.

``onnx_interp.OnnxClipRunner`` drives the reference runner loop
(``scripts/inference/onnx/inference.py:63-94``) through it, on the card
by default; ``onnx_interp.run_graph`` is it on the CPU.  The graph
runner uses library ops by design: it is a verification runtime, not a
serving path.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.export import onnx_minimal as om


def _pair_pads(pads):
    """ONNX pads [top, left, bottom, right] -> F.pad (l, r, t, b)."""
    t, l, b, r = pads
    return (int(l), int(r), int(t), int(b))


def _d2s_dcr(x, bs):
    n, c, h, w = x.shape
    co = c // (bs * bs)
    return (x.reshape(n, bs, bs, co, h, w)
            .permute(0, 3, 4, 1, 5, 2)
            .reshape(n, co, h * bs, w * bs))


def _s2d(x, bs):
    n, c, h, w = x.shape
    return (x.reshape(n, c, h // bs, bs, w // bs, bs)
            .permute(0, 3, 5, 1, 2, 4)
            .reshape(n, c * bs * bs, h // bs, w // bs))


def _resize_asymmetric(x, scale_h, scale_w):
    """ONNX Resize mode=linear coordinate_transformation_mode=asymmetric
    (TF1 resize_bilinear align_corners=F half_pixel_centers=F):
    src = dst / scale, corners clamped to the last row/col."""
    n, c, h, w = x.shape
    oh, ow = int(round(h * scale_h)), int(round(w * scale_w))
    sy = torch.arange(oh, dtype=torch.float32, device=x.device) / scale_h
    sx = torch.arange(ow, dtype=torch.float32, device=x.device) / scale_w
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    wy = (sy - y0).reshape(1, 1, -1, 1).to(x.dtype)
    wx = (sx - x0).reshape(1, 1, 1, -1).to(x.dtype)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    a = x[:, :, y0][:, :, :, x0]
    b = x[:, :, y0][:, :, :, x1]
    cc = x[:, :, y1][:, :, :, x0]
    d = x[:, :, y1][:, :, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + cc * wy * (1 - wx) + d * wy * wx)


def _qdq_scale_t(scale, ndim, axis):
    scale = scale.to(torch.float32)
    if scale.ndim == 0 or scale.numel() == 1:
        return scale.reshape(())
    shape = [1] * ndim
    shape[axis] = scale.numel()
    return scale.reshape(shape)


def model_float_dtype(model: Dict[str, Any]) -> np.dtype:
    """f16 for an fp16-quantized export (quantize_fp16 tier), else f32.
    Detected from the initializers (weights carry the compute dtype)."""
    for v in model["initializers"].values():
        if v.dtype == np.float16:
            return np.dtype(np.float16)
    return np.dtype(np.float32)


_INT_TARGETS = {om.UINT8: torch.uint8, om.INT32: torch.int32,
                om.INT64: torch.int64}


def run_graph_torch(model: Dict[str, Any], feeds: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Execute a decoded model (``onnx_minimal.decode_model``) with
    torch ops on ``device`` (default: the CUDA device): numpy arrays
    in, the graph outputs by name as numpy arrays out.

    fp16 graphs emulate the deployment runtime's half-precision storage
    between ops (compute f32, store f16).
    """
    from joshupscale_torch.training.trainer import exact_float32

    dev = resolve_device(device)
    fdt = model_float_dtype(model)
    store_half = fdt == np.float16

    def to_t(v):
        v = np.asarray(v)
        if v.dtype == np.float16:
            v = v.astype(np.float32)
        return torch.from_numpy(v.copy()).to(dev)

    env = {k: to_t(v) for k, v in model["initializers"].items()}
    env.update({k: to_t(v) for k, v in feeds.items()})
    # Edge storage precision: compute always runs in f32 tensors, but
    # fp16 graphs squash each value through f16 between nodes --
    # EXCEPT edges inside an explicit f32 island (a Cast-to-f32 fence
    # or keep_f32 initializers: the exporter's coordinate math), which
    # the deployment runtime stores at full precision too.
    half = {k: np.asarray(v).dtype == np.float16
            for k, v in model["initializers"].items()}
    half.update({k: np.asarray(v).dtype == np.float16
                 for k, v in feeds.items()})

    with torch.no_grad(), exact_float32():
        for node in model["nodes"]:
            op = node["op_type"]
            i = [env[x] if x else None for x in node["inputs"]]
            a = node["attrs"]
            out_name = node["outputs"][0]
            if op == "Transpose":
                r = i[0].permute(tuple(a["perm"]))
            elif op == "Mul":
                r = i[0] * i[1]
            elif op == "Add":
                r = i[0] + i[1]
            elif op == "Sub":
                r = i[0] - i[1]
            elif op == "Div":
                r = i[0] / i[1]
            elif op == "Concat":
                r = torch.cat(i, dim=a["axis"])
            elif op == "Relu":
                r = torch.relu(i[0])
            elif op == "Tanh":
                r = torch.tanh(i[0])
            elif op == "Conv":
                x = F.pad(i[0], _pair_pads(a["pads"]))
                r = F.conv2d(x, i[1], i[2] if len(i) > 2 else None,
                             stride=tuple(a["strides"]))
            elif op == "ConvTranspose":
                r = F.conv_transpose2d(i[0], i[1],
                                       i[2] if len(i) > 2 else None,
                                       stride=tuple(a["strides"]))
            elif op == "DepthToSpace":
                assert a["mode"] == "DCR"
                r = _d2s_dcr(i[0], a["blocksize"])
            elif op == "SpaceToDepth":
                r = _s2d(i[0], a["blocksize"])
            elif op == "Slice":
                starts, ends, axes, steps = (int(i[1][0]), int(i[2][0]),
                                             int(i[3][0]), int(i[4][0]))
                # torch has no negative-step slicing; resolve to indices
                # (negative axes index shape directly).
                dim = i[0].shape[axes]
                idx = list(range(dim))[slice(
                    starts, None if ends == -dim - 1 else ends, steps)]
                r = i[0].index_select(
                    axes if axes >= 0 else i[0].ndim + axes,
                    torch.tensor(idx, dtype=torch.long, device=dev))
            elif op == "GridSample":
                assert a["mode"] == "bilinear"
                assert a["padding_mode"] == "border"
                r = F.grid_sample(i[0], i[1], mode="bilinear",
                                  padding_mode="border",
                                  align_corners=bool(a["align_corners"]))
            elif op == "Resize":
                scales = i[2].tolist()
                r = _resize_asymmetric(i[0], float(scales[2]),
                                       float(scales[3]))
            elif op == "Clip":
                r = torch.clamp(i[0], min=i[1], max=i[2])
            elif op == "Identity":
                r = i[0]
            elif op == "Abs":
                r = torch.abs(i[0])
            elif op == "Sign":
                r = torch.sign(i[0])
            elif op == "Min":
                r = torch.minimum(i[0], i[1])
            elif op == "Max":
                r = torch.maximum(i[0], i[1])
            elif op == "ReduceMean":
                axes = a.get("axes")
                dims = tuple(axes) if axes else tuple(range(i[0].ndim))
                r = i[0].mean(dim=dims, keepdim=bool(a.get("keepdims", 1)))
            elif op == "Pad":
                pads = i[1].tolist()
                nd = i[0].ndim
                # ONNX [begins..., ends...] -> F.pad last-dim-first pairs.
                flat = []
                for d in range(nd - 1, -1, -1):
                    flat += [int(pads[d]), int(pads[d + nd])]
                cval = 0.0 if len(i) < 3 or i[2] is None else float(i[2])
                assert a.get("mode", "constant") == "constant"
                r = F.pad(i[0], flat, value=cval)
            elif op == "MaxPool":
                assert not any(a.get("pads", []))
                r = F.max_pool2d(i[0], kernel_size=tuple(a["kernel_shape"]),
                                 stride=tuple(a["strides"]))
            elif op == "QuantizeLinear":
                scale = _qdq_scale_t(i[1], i[0].ndim, a.get("axis"))
                # torch.round is round-half-to-even, the ONNX rule.
                r = torch.clamp(torch.round(i[0] / scale),
                                -128, 127).to(torch.int8)
            elif op == "DequantizeLinear":
                scale = _qdq_scale_t(i[1], i[0].ndim, a.get("axis"))
                r = i[0].to(torch.float32) * scale
            elif op == "Cast":
                if a["to"] in (om.FLOAT, om.FLOAT16):
                    # Float casts: compute stays f32; f16 targets round
                    # through half (the interpreter's f32-island rule).
                    r = i[0].to(torch.float32)
                    half[out_name] = a["to"] == om.FLOAT16
                    if half[out_name]:
                        r = r.to(torch.float16).to(torch.float32)
                else:
                    # Integer targets truncate like the numpy
                    # interpreter's astype.
                    r = i[0].to(_INT_TARGETS[a["to"]])
                    half[out_name] = False
                env[out_name] = r
                continue
            else:
                raise NotImplementedError(op)
            if r.dtype == torch.int8:
                half[out_name] = False
            else:
                in_half = [half.get(x, store_half) for x, v in
                           zip(node["inputs"], i)
                           if v is not None and v.is_floating_point()]
                half[out_name] = store_half and (not in_half
                                                 or any(in_half))
                if half[out_name]:
                    # Emulate f16 storage between nodes (compute f32).
                    r = r.to(torch.float16).to(torch.float32)
            env[out_name] = r

    out = {}
    for o in model["outputs"]:
        v = env[o["name"]].cpu().numpy()
        if store_half and v.dtype == np.float32:
            v = v.astype(np.float16)
        out[o["name"]] = v
    return out
