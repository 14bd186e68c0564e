"""From-scratch ONNX export of the inference model (no donor graph).

Port of ``joshupscale_tpu/export/onnx_export.py``: it takes the port's
param tree and writes, byte for byte, the file the JAX exporter writes
for the same params.  The params are first converted to the reference's
layouts (``export/weights.to_flat_numpy``), and every initializer --
the BN folds included -- is computed in numpy in the reference's order,
so the bits match.

Emits the reference-SHAPED deployment graph directly from the param
tree: the graph a reference user gets after their whole surgery
pipeline (tf2onnx -> simplify -> cleanup -> replace_dense_warp ->
remove_uint8; reference scripts/training/train_local.py:184-209 and
scripts/inference/onnx/*):

- all-NCHW body with a single NHWC input transpose on ``cur_frame``
  (cleanup.py:95-185 semantics),
- BN folded into Conv/ConvTranspose weights (onnxsim fusion semantics),
- the tfa dense warp as a native GridSample (bilinear, border,
  align_corners=0) fed by the ``grid - flow`` query points normalized
  exactly like replace_dense_warp.py:70-112 (slice-reverse (y,x)->(x,y),
  divide by (W/2, H/2), shift by (-1+1/W, -1+1/H)),
- float I/O (remove_uint8.py semantics; pre/postprocess stay as
  Mul/Add arithmetic),
- reference I/O names: input ``cur_frame`` [1,H,W,3] NHWC + states
  ``pre_gen`` / ``last_frame_i`` NCHW; outputs ``output`` (NHWC,
  [0,255] range), ``output_raw`` NCHW, ``out_frame_i`` NCHW
  (models.py:1073-1121 get_onnx_model naming).

Opset 16 (GridSample minimum, replace_dense_warp.py:69).  Initializers
are named with the param-tree dotted paths (``flow.conv_1.kernel``) so
``tools/onnx_to_npz.py`` maps them straight back.  The serializer is
the port's codec, ``export/onnx_minimal.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from joshupscale_torch.export import onnx_minimal as om
from joshupscale_torch.export.weights import nest_flat, to_flat_numpy
from joshupscale_torch.nn.layers import BN_EPS
from joshupscale_torch.ops.image import BGR_LUMA


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _fold_conv_bn(conv: Dict[str, Any], bn: Dict[str, Any]):
    """HWIO kernel + BN -> (HWIO kernel', bias') (models.common.conv_bn
    formula)."""
    inv = _np(bn["gamma"]) / np.sqrt(_np(bn["moving_variance"]) + BN_EPS)
    offset = _np(bn["beta"]) - _np(bn["moving_mean"]) * inv
    kernel = _np(conv["kernel"]) * inv
    if "bias" in conv:
        offset = offset + _np(conv["bias"]) * inv
    return kernel, offset


class _GraphBuilder:
    def __init__(self, fp16: bool = False, int8_ranges=None):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0
        # fp16 deployment tier (reference onnx/quantize_fp16.py:62-75,
        # convert_float_to_float16 with keep_io_types=False and no op
        # block list): every f32 initializer and value becomes f16;
        # Resize scales stay f32 (the reference fixes those back after
        # conversion, :69-75).
        self.fp16 = fp16
        # int8 QDQ tier (reference onnx/quantize_int8.py:176-206):
        # {conv dotted path: calibrated input absmax}.  Convs present
        # get a per-tensor symmetric activation Q/DQ on their input and
        # a per-channel symmetric weight Q/DQ pair (AddQDQPairToWeight
        # semantics: the f32 weight stays in the file); everything else
        # -- the bilinear-skip Resize, moving-avg nodes -- stays float,
        # matching the reference's nodes_to_exclude.
        self.int8_ranges = dict(int8_ranges or {})

    @property
    def float_type(self) -> int:
        return om.FLOAT16 if self.fp16 else om.FLOAT

    def tensor(self, name: str, arr: np.ndarray,
               keep_f32: bool = False) -> str:
        arr = np.asarray(arr)
        if self.fp16 and arr.dtype == np.float32 and not keep_f32:
            arr = arr.astype(np.float16)
        self.inits.append(om.make_tensor(name, arr))
        return name

    def node(self, op: str, inputs, out: str = None, **attrs) -> str:
        if out is None:
            self._n += 1
            out = f"t{self._n}"
        self.nodes.append(
            om.make_node(op, inputs, [out], name=f"{op.lower()}_{out}",
                         **attrs))
        return out

    def _qdq(self, x: str, scale: np.ndarray, name: str,
             axis: int = None) -> str:
        """Symmetric QuantizeLinear -> DequantizeLinear pair."""
        scale = np.asarray(scale, np.float32)
        s = self.tensor(f"{name}.scale", scale, keep_f32=True)
        zp = self.tensor(f"{name}.zero_point",
                         np.zeros(scale.shape, np.int8))
        attrs = {} if axis is None else {"axis": axis}
        q = self.node("QuantizeLinear", [x, s, zp], **attrs)
        return self.node("DequantizeLinear", [q, s, zp], **attrs)

    def _maybe_quantize(self, x: str, path: str, k_oihw: np.ndarray,
                        w_channel_axis: int):
        """int8 QDQ insertion for one conv: returns (x', weight name)."""
        w_name = self.tensor(f"{path}.kernel", k_oihw)
        absmax = self.int8_ranges.get(path)
        if absmax is None:
            return x, w_name
        x = self._qdq(x, np.float32(max(absmax, 1e-12) / 127.0),
                      f"{path}.act")
        reduce_axes = tuple(i for i in range(k_oihw.ndim)
                            if i != w_channel_axis)
        w_absmax = np.abs(k_oihw).max(axis=reduce_axes)
        w_scale = np.where(w_absmax > 0, w_absmax / 127.0,
                           1.0).astype(np.float32)
        w_name = self._qdq(w_name, w_scale, f"{path}.w",
                           axis=w_channel_axis)
        return x, w_name

    def conv(self, x: str, path: str, kernel_hwio: np.ndarray,
             bias: np.ndarray = None) -> str:
        k = np.transpose(kernel_hwio, (3, 2, 0, 1))  # HWIO -> OIHW
        kh, kw = k.shape[2], k.shape[3]
        x, w_name = self._maybe_quantize(x, path, _np(k), 0)
        inputs = [x, w_name]
        if bias is not None:
            inputs.append(self.tensor(f"{path}.bias", _np(bias)))
        return self.node(
            "Conv", inputs, kernel_shape=[kh, kw], strides=[1, 1],
            pads=[kh // 2, kw // 2, kh // 2, kw // 2])

    def conv_transpose_2x(self, x: str, path: str,
                          kernel_kkoi: np.ndarray,
                          bias: np.ndarray = None) -> str:
        # storage (2, 2, O, I) -> ONNX ConvTranspose weight (I, O, kH, kW)
        k = np.transpose(_np(kernel_kkoi), (3, 2, 0, 1))
        x, w_name = self._maybe_quantize(x, path, k, 1)  # O axis = 1
        inputs = [x, w_name]
        if bias is not None:
            inputs.append(self.tensor(f"{path}.bias", _np(bias)))
        return self.node(
            "ConvTranspose", inputs, kernel_shape=[2, 2], strides=[2, 2],
            pads=[0, 0, 0, 0])

    def res_blocks(self, x: str, params: Dict[str, Any],
                   scope: str) -> str:
        names = sorted(
            (k for k in params if k.startswith("block_")),
            key=lambda s: int(s.split("_")[1]))
        for name in names:
            blk = params[name]
            shortcut = x
            k1, b1 = _fold_conv_bn(blk["conv_1"], blk["bn_1"])
            x = self.conv(x, f"{scope}.{name}.conv_1", k1, b1)
            x = self.node("Relu", [x])
            k2, b2 = _fold_conv_bn(blk["conv_2"], blk["bn_2"])
            x = self.conv(x, f"{scope}.{name}.conv_2", k2, b2)
            if "fade" in blk:
                # Fade-in scale min(counter/period, 1) on the residual
                # branch (models/common.py Mutables.fade_in; reference
                # keras_layers.py FadeInLayer).  Static at export time;
                # a fully faded-in block (scale == 1) emits nothing.
                counter = float(np.asarray(blk["fade"]["counter"]))
                period = max(float(np.asarray(blk["fade"]["period"])),
                             1.0)
                scale = min(counter / period, 1.0)
                if scale != 1.0:
                    x = self.node(
                        "Mul",
                        [x, self.tensor(f"{scope}.{name}.fade_scale",
                                        np.float32(scale))])
            x = self.node("Add", [x, shortcut])
            x = self.node("Relu", [x])
        return x


def _emit_flow_net(g: _GraphBuilder, x: str, fp: Dict[str, Any]) -> str:
    """Flow net body -> the 32-channel head feeding DepthToSpace.

    Dispatches on the architecture recoverable from the param tree:
    the resnet flow's head conv is 1x1 (models/fnet.py
    flow_resnet_init), the autoencoder's is 3x3 (flow_autoencoder_init;
    reference models.py get_flow_autoencoder :334-481 -- the PS2-style
    pooling/upsampling ladder tf2onnx exports as MaxPool + Resize)."""
    head_kh = np.asarray(fp["conv_2"]["kernel"]).shape[0]
    if head_kh == 1:
        k1, b1 = _fold_conv_bn(fp["conv_1"], fp["bn_1"])
        x = g.conv(x, "flow.conv_1", k1, b1)
        x = g.node("Relu", [x])
        x = g.res_blocks(x, fp, "flow")
    else:
        names = sorted(
            (k for k in fp if k.startswith("block_")),
            key=lambda s: int(s.split("_")[1]))
        half = len(names) // 2
        for i, name in enumerate(names):
            blk = fp[name]
            k1, b1 = _fold_conv_bn(blk["conv_1"], blk["bn_1"])
            x = g.conv(x, f"flow.{name}.conv_1", k1, b1)
            x = g.node("Relu", [x])
            k2, b2 = _fold_conv_bn(blk["conv_2"], blk["bn_2"])
            x = g.conv(x, f"flow.{name}.conv_2", k2, b2)
            x = g.node("Relu", [x])
            if i < half:
                x = g.node("MaxPool", [x], kernel_shape=[2, 2],
                           strides=[2, 2], pads=[0, 0, 0, 0])
            else:
                x = g.node(
                    "Resize",
                    [x, "", g.tensor(f"flow.{name}.up_scales",
                                     np.asarray([1, 1, 2, 2], np.float32),
                                     keep_f32=True)],
                    mode="linear",
                    coordinate_transformation_mode="asymmetric")
        if "conv_1" in fp:  # odd filter list: mid conv after the ladder
            k1, b1 = _fold_conv_bn(fp["conv_1"], fp["bn_1"])
            x = g.conv(x, "flow.conv_1", k1, b1)
            x = g.node("Relu", [x])
    return g.conv(x, "flow.conv_2", _np(fp["conv_2"]["kernel"]),
                  fp["conv_2"]["bias"])


# BGR luma weights in NCHW broadcast form (single source:
# ops/image.py BGR_LUMA; x3 so the mean over the 3 channels is the
# luma-weighted value -- reference models.py get_inference_model
# 'brightness' Lambda).
_BGR_LUMA_NCHW = np.asarray(
    BGR_LUMA, np.float32).reshape(1, 3, 1, 1) * 3.0


def export_onnx(path: str, params: Dict[str, Any], frame_height: int,
                frame_width: int, num_flow_frames: int = 4,
                frame_moving_avg: Any = None,
                output_flow: bool = False,
                remove_flow: bool = False,
                fp16: bool = False,
                int8_ranges: Dict[str, float] = None,
                flow_pad_factor: int = None,
                normalize_brightness: bool = False) -> None:
    """Write the deployable ONNX graph for a resnet-flow (or
    autoencoder-flow) + resnet-generator inference model.

    ``params``: the port's inference param tree ``{"flow": ...,
    "generator": ...}`` (raw, as ``create_models`` or a trainer holds
    it; BN folded here).

    Deployment variants -- each reproduces the graph a reference user
    gets from the corresponding surgery script:

    - ``frame_moving_avg`` (a ``FrameMovingAvgConfig`` or option dict):
      temporal stabilization + scene-cut gate spliced between the
      generator clip and the output, so the filtered frame feeds both
      display and the recurrence (reference onnx/frame_moving_avg.py:
      99-307, incl. windowed mode, L1/L2 norms, tanh gain gate, luma
      normalization and the pre_warp limit).
    - ``output_flow``: the clip is rewired onto the warped frame and
      the generator body is dropped (reference onnx/output_flow.py:
      64-77).
    - ``remove_flow``: non-temporal single-frame graph -- flow net,
      warp and all state I/O removed, generator first-conv kernel
      sliced to the 3 frame channels (reference onnx/remove_flow.py:
      64-77).

    Quantization tiers: ``fp16=True`` (reference quantize_fp16.py) or
    ``int8_ranges={conv path: calibrated input absmax}`` (reference
    quantize_int8.py QDQ form; get the ranges from
    ``export.quantize.calibrate``).  Mutually exclusive.

    Flow-side options (the autoencoder/PS2-style serving configs;
    reference models.py get_inference_model :680-830 builds these into
    the exported Keras graph, so the reference's ONNX door carries
    them too):

    - ``flow_pad_factor``: zero-pad the flow net's input frames to a
      size multiple (pooling ladders need it); the flow field is
      sliced back to the frame size and the ``last_frame_i`` state
      tensors are carried at the PADDED size.
    - ``normalize_brightness``: mean-luma is subtracted before the
      flow net, re-added to the warped frame, and subtracted again
      from the recurrent ``output_raw`` state; the display ``output``
      keeps true brightness.
    """
    if fp16 and int8_ranges:
        raise ValueError("fp16 and int8_ranges are mutually exclusive")
    # Numpy leaves in the reference's layouts (HWIO conv kernels,
    # (2, 2, O, I) deconv kernels): what the reference exporter reads.
    params = nest_flat(to_flat_numpy(params))
    if remove_flow:
        if frame_moving_avg is not None or output_flow:
            raise ValueError(
                "remove_flow excludes frame_moving_avg/output_flow "
                "(there is no warp to blend or display)")
        # flow_pad_factor / normalize_brightness are flow-side options;
        # the model's remove_flow branch ignores them
        # (models/inference.py), so the exported graph drops them too
        # and callers may pass the model's fields verbatim.
        _export_remove_flow(path, params, frame_height,
                            frame_width, fp16=fp16,
                            int8_ranges=int8_ranges)
        return
    if frame_moving_avg is not None and output_flow:
        raise ValueError(
            "output_flow drops the generator; frame_moving_avg would "
            "have nothing to blend")
    h, w = frame_height, frame_width
    hr_h, hr_w = h * 4, w * 4
    if flow_pad_factor:
        f = int(flow_pad_factor)
        ph, pw = ((h + f - 1) // f) * f, ((w + f - 1) // f) * f
    else:
        ph, pw = h, w
    k = num_flow_frames - 1
    g = _GraphBuilder(fp16, int8_ranges)

    # ---- inputs ------------------------------------------------------
    inputs = [om.make_value_info("cur_frame", g.float_type, [1, h, w, 3])]
    inputs.append(
        om.make_value_info("pre_gen", g.float_type, [1, 3, hr_h, hr_w]))
    for i in range(k):
        inputs.append(
            om.make_value_info(f"last_frame_{i}", g.float_type,
                               [1, 3, ph, pw]))

    # ---- preprocess (remove_uint8 keeps the scale arithmetic) --------
    t_cur = g.node("Transpose", ["cur_frame"], perm=[0, 3, 1, 2])
    scale = g.tensor("pre.scale", np.float32(1.0 / 255.0))
    half = g.tensor("pre.half", np.float32(0.5))
    pre = g.node("Sub", [g.node("Mul", [t_cur, scale]), half],
                 out="pre")

    # ---- brightness normalization (per-sample mean luma) -------------
    bright = None
    cur_pad = pre
    if normalize_brightness:
        bright = g.node(
            "ReduceMean",
            [g.node("Mul", [pre, g.tensor("bright.luma",
                                          _BGR_LUMA_NCHW)])],
            axes=[1, 2, 3], keepdims=1, out="brightness")
        cur_pad = g.node("Sub", [pre, bright])

    # ---- flow-input padding ------------------------------------------
    if (ph, pw) != (h, w):
        top, left = (ph - h) // 2, (pw - w) // 2
        pads = np.asarray(
            [0, 0, top, left, 0, 0, ph - h - top, pw - w - left],
            np.int64)
        cur_pad = g.node(
            "Pad", [cur_pad, g.tensor("pad.pads", pads)],
            mode="constant")

    # ---- flow net ----------------------------------------------------
    fp = params["flow"]
    x = g.node("Concat",
               [cur_pad] + [f"last_frame_{i}" for i in range(k)], axis=1)
    x = _emit_flow_net(g, x, fp)
    flow = g.node("DepthToSpace", [x], blocksize=4, mode="DCR",
                  out="flow")
    if (ph, pw) != (h, w):
        # Un-pad the flow field back to the frame's HR grid (reference
        # get_inference_model 'unpad' Lambda).
        oy, ox = ((ph - h) // 2) * 4, ((pw - w) // 2) * 4
        for axis, start, size in ((2, oy, hr_h), (3, ox, hr_w)):
            flow = g.node(
                "Slice",
                [flow,
                 g.tensor(f"unpad{axis}.start",
                          np.asarray([start], np.int64)),
                 g.tensor(f"unpad{axis}.end",
                          np.asarray([start + size], np.int64)),
                 g.tensor(f"unpad{axis}.axis",
                          np.asarray([axis], np.int64)),
                 g.tensor(f"unpad{axis}.step",
                          np.asarray([1], np.int64))])

    # ---- dense warp as GridSample (replace_dense_warp semantics) ----
    flow_nhwc = g.node("Transpose", [flow], perm=[0, 2, 3, 1])
    yy, xx = np.meshgrid(np.arange(hr_h, dtype=np.float32),
                         np.arange(hr_w, dtype=np.float32),
                         indexing="ij")
    base = np.stack([yy, xx], axis=-1)[None]  # (1, 4H, 4W, 2) (y, x)
    # The COORDINATE math stays f32 in the fp16 tier: float16 cannot
    # represent sub-pixel offsets once the HR coordinate reaches 1024
    # (f16(1919.0 - 0.37) == 1919.0), so an f16 grid snaps most of a
    # 1080p frame's warp to whole pixels and the error compounds
    # through the recurrence.  Same reasoning keeps Resize scales f32
    # (the reference's fp16 converter fixes those back too,
    # onnx/quantize_fp16.py:69-75).  GridSample runs on a cast-up copy
    # and the sample is cast back to storage precision.
    if g.fp16:
        flow_nhwc = g.node("Cast", [flow_nhwc], to=om.FLOAT)
    query = g.node(
        "Sub", [g.tensor("warp.base_grid", base, keep_f32=True),
                flow_nhwc])
    # (y, x) -> (x, y) via the same reverse slice the reference emits.
    sliced = g.node(
        "Slice",
        [query,
         g.tensor("warp.sl_start", np.asarray([-1], np.int64)),
         g.tensor("warp.sl_end", np.asarray([-3], np.int64)),
         g.tensor("warp.sl_axis", np.asarray([-1], np.int64)),
         g.tensor("warp.sl_step", np.asarray([-1], np.int64))])
    norm = g.node(
        "Div", [sliced, g.tensor(
            "warp.norm", np.asarray([hr_w * 0.5, hr_h * 0.5],
                                    np.float32), keep_f32=True)])
    grid = g.node(
        "Add", [norm, g.tensor(
            "warp.shift", np.asarray(
                [-1 + 1 / hr_w, -1 + 1 / hr_h], np.float32),
            keep_f32=True)])
    gs_x = (g.node("Cast", ["pre_gen"], to=om.FLOAT)
            if g.fp16 else "pre_gen")
    pre_warp = g.node(
        "GridSample", [gs_x, grid], mode="bilinear",
        padding_mode="border", align_corners=0,
        out=None if (normalize_brightness or g.fp16) else "pre_warp")
    if g.fp16:
        pre_warp = g.node(
            "Cast", [pre_warp], to=om.FLOAT16,
            out=None if normalize_brightness else "pre_warp")
    if normalize_brightness:
        # The recurrent state is carried at normalized brightness;
        # the generator sees the warp at the CURRENT frame's
        # brightness (reference get_inference_model: pre_warp +=
        # brightness).
        pre_warp = g.node("Add", [pre_warp, bright], out="pre_warp")

    # ``display`` is the true-brightness tensor feeding the u8 output;
    # ``output_raw`` (the recurrent state) re-subtracts brightness.
    if output_flow:
        # Reference surgery: the clip node's input becomes the warped
        # frame; the generator body is dead and never emitted
        # (onnx/output_flow.py:64-77 + the simplify pass).
        display = g.node(
            "Clip", [pre_warp, g.tensor("clip.min", np.float32(-0.5)),
                     g.tensor("clip.max", np.float32(0.5))],
            out=None if normalize_brightness else "output_raw")
    else:
        # ---- generator -----------------------------------------------
        gp = params["generator"]
        s2d = g.node("SpaceToDepth", [pre_warp], blocksize=4)
        x = g.node("Concat", [pre, s2d], axis=1)
        k1, b1 = _fold_conv_bn(gp["conv_1"], gp["bn_1"])
        x = g.conv(x, "generator.conv_1", k1, b1)
        x = g.node("Relu", [x])
        x = g.res_blocks(x, gp, "generator")
        # conv_trans_1 (bias-free) + bn_2 folded along the O axis.
        inv = _np(gp["bn_2"]["gamma"]) / np.sqrt(
            _np(gp["bn_2"]["moving_variance"]) + BN_EPS)
        offset = (_np(gp["bn_2"]["beta"])
                  - _np(gp["bn_2"]["moving_mean"]) * inv)
        kt1 = _np(gp["conv_trans_1"]["kernel"]) * inv[None, None, :, None]
        x = g.conv_transpose_2x(x, "generator.conv_trans_1", kt1, offset)
        x = g.node("Relu", [x])
        x = g.conv_transpose_2x(
            x, "generator.conv_trans_2", gp["conv_trans_2"]["kernel"],
            gp["conv_trans_2"]["bias"])
        x = g.node("Tanh", [x])
        # TF1 bilinear x4 skip: Resize with asymmetric coordinates
        # (align_corners=False, half_pixel_centers=False).
        up = g.node(
            "Resize",
            [pre, "", g.tensor("up.scales",
                               np.asarray([1, 1, 4, 4], np.float32),
                               keep_f32=True)],
            mode="linear", coordinate_transformation_mode="asymmetric")
        x = g.node("Add", [up, x])
        raw_name = ("output_pre_mask" if frame_moving_avg is not None
                    else None if normalize_brightness else "output_raw")
        clipped = g.node(
            "Clip", [x, g.tensor("clip.min", np.float32(-0.5)),
                     g.tensor("clip.max", np.float32(0.5))],
            out=raw_name)
        display = clipped
        if frame_moving_avg is not None:
            display = _emit_moving_avg(
                g, clipped, pre_warp, frame_moving_avg, hr_h, hr_w,
                out_name=None if normalize_brightness else "output_raw")

    if normalize_brightness:
        g.node("Sub", [display, bright], out="output_raw")

    # ---- postprocess + outputs --------------------------------------
    post = g.node("Mul", [g.node("Add", [display, half]),
                          g.tensor("post.scale", np.float32(255.0))])
    g.node("Transpose", [post], perm=[0, 2, 3, 1], out="output")
    g.node("Identity", [cur_pad], out="out_frame_0")
    for i in range(k - 1):
        g.node("Identity", [f"last_frame_{i}"], out=f"out_frame_{i + 1}")

    outputs = [om.make_value_info("output", g.float_type,
                                  [1, hr_h, hr_w, 3]),
               om.make_value_info("output_raw", g.float_type,
                                  [1, 3, hr_h, hr_w])]
    for i in range(k):
        outputs.append(om.make_value_info(f"out_frame_{i}", g.float_type,
                                          [1, 3, ph, pw]))

    graph = om.make_graph("joshupscale", g.nodes, inputs, outputs,
                          g.inits)
    with open(path, "wb") as f:
        f.write(om.make_model(graph, opset=16))


# BGR luma weights, reference frame_moving_avg.py LUMA_NORM (x3 so the
# weighted mean over 3 channels averages to a luma-weighted value;
# same triple as the brightness term, single-sourced above).
_LUMA_NORM = _BGR_LUMA_NCHW


def _emit_moving_avg(g: _GraphBuilder, clipped: str, pre_warp: str,
                     config: Any, hr_h: int, hr_w: int,
                     out_name: str = "output_raw") -> str:
    """Splice the temporal-stabilization blend between the generator
    clip and the output (reference frame_moving_avg.py:152-307): the
    returned tensor feeds both display and the recurrence.  NCHW."""
    from joshupscale_torch.ops.temporal import FrameMovingAvgConfig

    if isinstance(config, dict):
        config = FrameMovingAvgConfig(**config)
    cfg = config

    warp = pre_warp
    if cfg.limit:
        warp = g.node(
            "Max", [g.node("Min", [warp,
                                   g.tensor("ma.lim_max",
                                            np.float32(0.5))]),
                    g.tensor("ma.lim_min", np.float32(-0.5))])

    diff = g.node("Sub", [clipped, warp])
    if cfg.norm == "l1":
        diff = g.node("Abs", [diff])
    elif cfg.norm == "l2":
        diff = g.node("Mul", [diff, diff])
    else:
        raise ValueError(f"Unknown norm type {cfg.norm}")

    gain_coef = 1.0 if cfg.gain == 0 else float(cfg.gain)
    if cfg.window == 0:
        if cfg.luma_normalize:
            kernel = _LUMA_NORM * gain_coef
            if cfg.norm == "l2":
                kernel = kernel * _LUMA_NORM
            diff = g.node("Mul", [diff, g.tensor("ma.gain", kernel)])
            mean = g.node("ReduceMean", [diff])
        else:
            mean = g.node("ReduceMean", [diff])
            if cfg.gain != 0:
                mean = g.node(
                    "Mul", [mean, g.tensor("ma.gain",
                                           np.float32(gain_coef))])
        pads = None
    else:
        win = int(cfg.window)
        out_shape = [(d + win - 1) // win * win for d in (hr_h, hr_w)]
        pads = [((s - d) // 2, s - d - (s - d) // 2)
                for s, d in zip(out_shape, (hr_h, hr_w))]
        kernel = np.ones((1, 3, win, win), np.float32) \
            / 3.0 / win / win * gain_coef
        if cfg.luma_normalize:
            kernel = kernel * _LUMA_NORM
            if cfg.norm == "l2":
                kernel = kernel * _LUMA_NORM
        mean = g.node(
            "Conv", [diff, g.tensor("ma.mean_kernel", kernel)],
            kernel_shape=[win, win], strides=[win, win],
            pads=[pads[0][0], pads[1][0], pads[0][1], pads[1][1]])

    cond = g.node(
        "Add", [mean, g.tensor(
            "ma.threshold", np.float32(-cfg.threshold * gain_coef))])
    cond = g.node("Sign" if cfg.gain == 0 else "Tanh", [cond])

    if cfg.window != 0:
        win = int(cfg.window)
        cond = g.node(
            "Resize",
            [cond, "", g.tensor(
                "ma.mask_scales",
                np.asarray([1, 1, win, win], np.float32),
                keep_f32=True)],
            mode="linear", coordinate_transformation_mode="asymmetric")
        if any(p != 0 for pair in pads for p in pair):
            out_shape = [(d + win - 1) // win * win
                         for d in (hr_h, hr_w)]
            for axis, (dim, (lo, hi)) in enumerate(
                    zip(out_shape, pads), start=2):
                if lo == 0 and hi == 0:
                    continue
                cond = g.node(
                    "Slice",
                    [cond,
                     g.tensor(f"ma.crop{axis}.start",
                              np.asarray([lo], np.int64)),
                     g.tensor(f"ma.crop{axis}.end",
                              np.asarray([dim - hi], np.int64)),
                     g.tensor(f"ma.crop{axis}.axis",
                              np.asarray([axis], np.int64)),
                     g.tensor(f"ma.crop{axis}.step",
                              np.asarray([1], np.int64))])

    s = float(cfg.strength)
    mask = g.node(
        "Add", [g.node("Mul", [cond, g.tensor("ma.c2",
                                              np.float32(-s / 2))]),
                g.tensor("ma.c1", np.float32(s / 2))])
    mask2 = g.node(
        "Add", [g.node("Mul", [cond, g.tensor("ma.c1b",
                                              np.float32(s / 2))]),
                g.tensor("ma.c3", np.float32(1 - s / 2))])
    return g.node(
        "Add", [g.node("Mul", [warp, mask]),
                g.node("Mul", [clipped, mask2])],
        out=out_name)


def _export_remove_flow(path: str, params: Dict[str, Any],
                        frame_height: int, frame_width: int,
                        fp16: bool = False,
                        int8_ranges: Dict[str, float] = None) -> None:
    """Non-temporal single-frame graph: flow net, warp and state I/O
    removed; the generator first conv keeps only the 3 frame input
    channels (reference onnx/remove_flow.py:64-77 slices the weights
    with ``weights[:, :3, :, :]`` after rewiring the concat away)."""
    h, w = frame_height, frame_width
    hr_h, hr_w = h * 4, w * 4
    g = _GraphBuilder(fp16, int8_ranges)

    inputs = [om.make_value_info("cur_frame", g.float_type, [1, h, w, 3])]
    t_cur = g.node("Transpose", ["cur_frame"], perm=[0, 3, 1, 2])
    scale = g.tensor("pre.scale", np.float32(1.0 / 255.0))
    half = g.tensor("pre.half", np.float32(0.5))
    pre = g.node("Sub", [g.node("Mul", [t_cur, scale]), half],
                 out="pre")

    gp = params["generator"]
    k1, b1 = _fold_conv_bn(gp["conv_1"], gp["bn_1"])
    k1 = k1[:, :, :3, :]  # HWIO: keep the frame channels only
    x = g.conv(pre, "generator.conv_1", k1, b1)
    x = g.node("Relu", [x])
    x = g.res_blocks(x, gp, "generator")
    inv = _np(gp["bn_2"]["gamma"]) / np.sqrt(
        _np(gp["bn_2"]["moving_variance"]) + BN_EPS)
    offset = (_np(gp["bn_2"]["beta"])
              - _np(gp["bn_2"]["moving_mean"]) * inv)
    kt1 = _np(gp["conv_trans_1"]["kernel"]) * inv[None, None, :, None]
    x = g.conv_transpose_2x(x, "generator.conv_trans_1", kt1, offset)
    x = g.node("Relu", [x])
    x = g.conv_transpose_2x(
        x, "generator.conv_trans_2", gp["conv_trans_2"]["kernel"],
        gp["conv_trans_2"]["bias"])
    x = g.node("Tanh", [x])
    up = g.node(
        "Resize",
        [pre, "", g.tensor("up.scales",
                           np.asarray([1, 1, 4, 4], np.float32),
                           keep_f32=True)],
        mode="linear", coordinate_transformation_mode="asymmetric")
    x = g.node("Add", [up, x])
    out_raw = g.node(
        "Clip", [x, g.tensor("clip.min", np.float32(-0.5)),
                 g.tensor("clip.max", np.float32(0.5))],
        out="output_raw")
    post = g.node("Mul", [g.node("Add", [out_raw, half]),
                          g.tensor("post.scale", np.float32(255.0))])
    g.node("Transpose", [post], perm=[0, 2, 3, 1], out="output")

    outputs = [om.make_value_info("output", g.float_type,
                                  [1, hr_h, hr_w, 3])]
    graph = om.make_graph("joshupscale", g.nodes, inputs, outputs,
                          g.inits)
    with open(path, "wb") as f:
        f.write(om.make_model(graph, opset=16))
