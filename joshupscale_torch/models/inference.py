"""Recurrent single-frame inference model.

Port of ``joshupscale_tpu/models/inference.py``.  Per frame:

    1. pre  = cur/255 - 0.5                       (unless skip_processing)
    2. optional brightness normalization, optional zero-pad to a
       flow_pad_factor multiple
    3. flow = FNet(pre_pad, last_frames...)       (s2d: (N, H, W, 32))
    4. unpad flow; pre_warp = dense_warp(pre_gen, flow)
    5. out = Generator(pre, pre_warp)             (s2d: (N, H, W, 48))
       [frame moving average | output_flow: clip(pre_warp)]
    state': pre_gen' = out (brightness taken back out; u8 with u8_state),
            last_frames' = [pre_pad] + last_frames[:-1]

``s2d_mode`` (the serving default) keeps the recurrence in
space-to-depth form; without it the state is the HR frame and the warp
and the generator's tail run on the HR grid.  ``remove_flow`` is the
non-temporal variant: no flow net, no state, the generator on the frame
alone.  ``apply`` is functional like the reference; the engine keeps the
state in fixed device tensors and commits ``new_state`` into them in
place.  ``apply_train`` is the step on raw params in training form
(pixel path, ``Mutables``), which the single-step FRVSR trainer runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.models.fnet import prepare_flow_resnet
from joshupscale_torch.models.generator import prepare_generator_resnet
from joshupscale_torch.ops.image import (
    brightness,
    clip,
    postprocess,
    preprocess,
)
from joshupscale_torch.ops.space_depth import depth_to_space, space_to_depth
from joshupscale_torch.ops.temporal import frame_moving_avg
from joshupscale_torch.ops.warp import dense_image_warp, dense_image_warp_s2d

State = Dict[str, Any]


@dataclasses.dataclass(frozen=True, eq=False)
class InferenceModel:
    """Functional recurrent VSR step.

    ``flow_apply(params, frames, s2d_output=...)`` and
    ``generator_apply(params, frame, pre_warp, s2d_output=...)`` are the
    bound nets; they take the serving params ``prepare_params`` makes
    (``flow_prepare`` prepares the flow net's).  ``compute_dtype`` is
    the networks' activation dtype.  ``frame_moving_avg`` is a
    ``FrameMovingAvgConfig`` or None.  ``flow_train(params, frames,
    mut)`` and ``generator_train(params, frame, pre_warp, mut)`` are the
    nets' training forms, on raw params (``apply_train``).
    """

    flow_apply: Optional[Callable[..., torch.Tensor]]
    generator_apply: Callable[..., torch.Tensor]
    num_flow_frames: int = 4
    frame_height: int = 270
    frame_width: int = 480
    skip_processing: bool = False
    compute_dtype: torch.dtype = torch.float32
    s2d_mode: bool = True
    deferred_display: bool = True
    flow_pad_factor: Optional[int] = None
    normalize_brightness: bool = False
    frame_moving_avg: Any = None
    output_flow: bool = False
    remove_flow: bool = False
    u8_state: bool = False
    flow_prepare: Callable[..., Any] = prepare_flow_resnet
    flow_train: Optional[Callable[..., torch.Tensor]] = None
    generator_train: Optional[Callable[..., torch.Tensor]] = None

    def __post_init__(self):
        if not self.remove_flow and self.num_flow_frames < 2:
            raise ValueError("flow num_inputs must be >= 2 (current frame "
                             "+ at least one last frame)")

    # -- geometry ----------------------------------------------------------

    def _padded(self, size: int) -> int:
        f = self.flow_pad_factor
        return size if f is None else (size + f - 1) // f * f

    @property
    def padded_height(self) -> int:
        return self._padded(self.frame_height)

    @property
    def padded_width(self) -> int:
        return self._padded(self.frame_width)

    @property
    def num_last_frames(self) -> int:
        return self.num_flow_frames - 1

    # -- state -------------------------------------------------------------

    def init_state(self, batch_size: int = 1, dtype=torch.float32,
                   device: DeviceLike = None) -> State:
        """Initial recurrent state on ``device`` (default: the CUDA
        device, as ``resolve_device`` reads it): ``pre_gen`` (s2d
        (N, H, W, 48), u8 127 with ``u8_state``; pixel (N, 4H, 4W, 3))
        and the last-frames shift register at the padded size, current
        frame first.  Empty under ``remove_flow``."""
        device = resolve_device(device)
        if self.remove_flow:
            return {}
        h, w = self.frame_height, self.frame_width
        if self.s2d_mode and self.u8_state:
            # u8 127 is about float 0.0 after dequantization (-0.002).
            pre_gen = torch.full((batch_size, h, w, 48), 127,
                                 dtype=torch.uint8, device=device)
        elif self.s2d_mode:
            pre_gen = torch.zeros((batch_size, h, w, 48), dtype=dtype,
                                  device=device)
        else:
            pre_gen = torch.zeros((batch_size, h * 4, w * 4, 3),
                                  dtype=dtype, device=device)
        ph, pw = self.padded_height, self.padded_width
        return {
            "pre_gen": pre_gen,
            "last_frames": [
                torch.zeros((batch_size, ph, pw, 3), dtype=dtype,
                            device=device)
                for _ in range(self.num_last_frames)
            ],
        }

    def prepare_net(self, name: str, params, device,
                    calibration: bool = False):
        """One net's raw params (``name`` "flow" or "generator") -> its
        serving params on ``device`` in ``compute_dtype``: every fold,
        cast and constant table of the step, made once ahead of serving,
        so a step copies nothing from the host.  Float or int8 params
        (``export/quantize.py``) alike.  ``calibration`` gives the
        calibration sweep's route: no batch norm folded, each float conv
        labelled with its dotted path (``flow.block_1.conv_1``...)."""
        def to_dev(tree):
            if isinstance(tree, dict):
                return {k: to_dev(v) for k, v in tree.items()}
            return tree.to(device)

        path = name if calibration else None
        cdt = self.compute_dtype
        if name == "generator":
            return prepare_generator_resnet(
                to_dev(params), cdt,
                s2d_output=self.s2d_mode and not self.remove_flow,
                frame_only=self.remove_flow, path=path)
        return self.flow_prepare(to_dev(params), cdt, path=path)

    def prepare_params(self, params, device,
                       calibration: bool = False) -> Dict[str, Any]:
        """Raw params -> the serving params ``apply`` takes, on
        ``device`` (``prepare_net`` for each net the model runs)."""
        nets = ["generator"] + ([] if self.remove_flow else ["flow"])
        return {name: self.prepare_net(name, params[name], device,
                                       calibration) for name in nets}

    # -- forward -----------------------------------------------------------

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad NHWC ``x`` to the padded size, ``dh // 2`` rows on
        top (``dw // 2`` columns on the left) and the rest after."""
        dh = self.padded_height - self.frame_height
        dw = self.padded_width - self.frame_width
        if not dh and not dw:
            return x
        return F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))

    def _unpad_flow(self, flow: torch.Tensor, scale: int) -> torch.Tensor:
        """Crop a flow on the padded grid (``scale`` 1: s2d blocks, i.e.
        LR pixels; 4: HR pixels) back to the frame."""
        oy = (self.padded_height - self.frame_height) // 2 * scale
        ox = (self.padded_width - self.frame_width) // 2 * scale
        h, w = self.frame_height * scale, self.frame_width * scale
        if flow.shape[1] == h and flow.shape[2] == w:
            return flow
        return flow[:, oy:oy + h, ox:ox + w, :]

    def _preprocess(self, cur_frame: torch.Tensor) -> torch.Tensor:
        pre = cur_frame if self.skip_processing else preprocess(cur_frame)
        return pre.to(self.compute_dtype)

    def apply(self, params, cur_frame: torch.Tensor,
              state: State) -> Tuple[Dict[str, Any], State]:
        """One recurrent step on serving params (``prepare_params``):
        ``(outputs, new_state)``.

        In s2d mode ``outputs["output_s2d"]`` is the (N, H, W, 48)
        display tensor.  "output" is the (N, 4H, 4W, 3) uint8 frame,
        made in the step unless the display is deferred (s2d mode) or
        ``skip_processing`` holds; with ``skip_processing``,
        "output_denorm" is the float HR frame.
        """
        if self.remove_flow:
            pre = self._preprocess(cur_frame)
            out = self.generator_apply(params["generator"], pre, None,
                                       s2d_output=False)
            return self._hr_outputs(out), state
        inter, flow_state = self.apply_flow_stage(
            params, cur_frame, {"last_frames": state["last_frames"]})
        outputs, gen_state = self.apply_gen_stage(
            params, inter, {"pre_gen": state["pre_gen"]})
        return outputs, {**gen_state, **flow_state}

    def apply_flow_stage(self, params, cur_frame: torch.Tensor,
                         state: State) -> Tuple[Dict[str, Any], State]:
        """Preprocess, brightness, pad + flow net; returns ``{"pre",
        "flow"[, "bright"]}`` and the new ``{"last_frames"}`` (the
        padded, brightness-normalized frame first)."""
        pre = self._preprocess(cur_frame)
        cur_pad = pre
        inter = {"pre": pre}
        if self.normalize_brightness:
            inter["bright"] = brightness(pre)
            cur_pad = cur_pad - inter["bright"]
        cur_pad = self._pad(cur_pad)
        last_frames = [f.to(self.compute_dtype)
                       for f in state["last_frames"]]
        flow = self.flow_apply(params["flow"], [cur_pad] + last_frames,
                               s2d_output=self.s2d_mode)
        inter["flow"] = self._unpad_flow(flow, 1 if self.s2d_mode else 4)
        new_state = {
            "last_frames": [cur_pad.to(state["last_frames"][0].dtype)]
            + list(state["last_frames"][:-1]),
        }
        return inter, new_state

    def apply_gen_stage(self, params, inter: Dict[str, Any],
                        state: State) -> Tuple[Dict[str, Any], State]:
        """Warp + generator (+ moving average); returns the outputs and
        ``{"pre_gen"}``."""
        cdt = self.compute_dtype
        pre_gen = state["pre_gen"]
        u8_state = self.u8_state and self.s2d_mode
        if u8_state:
            # The warp gathers the u8 table and dequantizes in its blend.
            pre_warp = dense_image_warp_s2d(pre_gen, inter["flow"]).to(cdt)
        elif self.s2d_mode:
            pre_warp = dense_image_warp_s2d(pre_gen.to(cdt), inter["flow"])
        else:
            pre_warp = dense_image_warp(pre_gen.to(cdt), inter["flow"])
        bright = inter.get("bright")
        if bright is not None:
            pre_warp = pre_warp + bright

        if self.output_flow:
            # The clipped warp feeds display and state; the reference's
            # generator is dead code here, so it does not run.
            out = torch.clamp(pre_warp, -0.5, 0.5)
        else:
            out = self.generator_apply(params["generator"], inter["pre"],
                                       pre_warp, s2d_output=self.s2d_mode)
            if self.frame_moving_avg is not None:
                out = self._moving_avg(out, pre_warp)
        output_raw = out if bright is None else out - bright

        if u8_state:
            # Clip first: the brightness can push output_raw out of range.
            new_pre_gen = postprocess(torch.clamp(output_raw, -0.5, 0.5))
        else:
            new_pre_gen = output_raw.to(pre_gen.dtype)
        if not self.s2d_mode:
            return self._hr_outputs(out), {"pre_gen": new_pre_gen}
        outputs = {"output_s2d": out}
        if self.skip_processing:
            outputs["output_denorm"] = depth_to_space(out, 4).float()
        elif not self.deferred_display:
            outputs["output"] = postprocess(depth_to_space(out, 4))
        return outputs, {"pre_gen": new_pre_gen}

    def apply_train(self, params, cur_frame: torch.Tensor, state: State,
                    mut) -> Tuple[Dict[str, Any], State]:
        """One recurrent step on raw params in training form (batch norm
        as ``mut`` says, a ``models.common.Mutables``), always on the
        pixel path, as the reference's ``apply`` runs under training
        Mutables.  ``state["pre_gen"]`` is the (N, 4H, 4W, 3) previous
        output.  Returns float32 ``output_denorm``, ``output_raw``
        (brightness taken back out), ``pre_warp`` and ``flow`` (the
        last two absent under ``remove_flow``) and the new state."""
        pre = self._preprocess(cur_frame)
        if self.remove_flow:
            out = self.generator_train(params["generator"], pre, None,
                                       mut.scoped("generator")).float()
            return {"output_denorm": out, "output_raw": out}, state
        cdt = self.compute_dtype
        cur_pad = pre
        bright = None
        if self.normalize_brightness:
            bright = brightness(pre)
            cur_pad = cur_pad - bright
        cur_pad = self._pad(cur_pad)
        last_frames = [f.to(cdt) for f in state["last_frames"]]
        flow = self._unpad_flow(self.flow_train(
            params["flow"], [cur_pad] + last_frames, mut.scoped("flow")), 4)
        pre_warp = dense_image_warp(state["pre_gen"].to(cdt), flow)
        if bright is not None:
            pre_warp = pre_warp + bright
        if self.output_flow:
            out = clip(pre_warp, -0.5, 0.5)
        else:
            out = self.generator_train(params["generator"], pre, pre_warp,
                                       mut.scoped("generator"))
            if self.frame_moving_avg is not None:
                out = frame_moving_avg(out, pre_warp, self.frame_moving_avg)
        output_raw = out if bright is None else out - bright
        outputs = {"output_denorm": out.float(),
                   "output_raw": output_raw.float(),
                   "pre_warp": pre_warp.float(), "flow": flow.float()}
        new_state = {
            "pre_gen": output_raw.to(state["pre_gen"].dtype),
            "last_frames": [cur_pad.to(state["last_frames"][0].dtype)]
            + list(state["last_frames"][:-1]),
        }
        return outputs, new_state

    def _hr_outputs(self, out: torch.Tensor) -> Dict[str, Any]:
        """The outputs of an HR (pixel-form) display frame."""
        if self.skip_processing:
            return {"output_denorm": out.float()}
        return {"output": postprocess(out)}

    def _moving_avg(self, gen: torch.Tensor,
                    pre_warp: torch.Tensor) -> torch.Tensor:
        """``frame_moving_avg``; on s2d tensors, window 0 runs on an
        (N, Hb, Wb*16, 3) view (a global mean and elementwise work do
        not care for the layout), a window through the HR grid."""
        cfg = self.frame_moving_avg
        if not self.s2d_mode:
            return frame_moving_avg(gen, pre_warp, cfg)
        if cfg.window == 0:
            n, hb, wb, cs = gen.shape
            view = (n, hb, wb * (cs // 3), 3)
            out = frame_moving_avg(gen.reshape(view),
                                   pre_warp.reshape(view), cfg)
            return out.reshape(gen.shape)
        return space_to_depth(frame_moving_avg(
            depth_to_space(gen, 4), depth_to_space(pre_warp, 4), cfg), 4)
