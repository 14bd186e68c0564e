"""Recurrent single-frame inference model, s2d serving form.

Port of the serving subset of ``joshupscale_tpu/models/inference.py``.
Per frame:

    1. pre  = cur/255 - 0.5                        (unless skip_processing)
    2. flow = FNet(pre, last_frames...)            -> (N, H, W, 32) s2d
    3. pre_warp = dense_warp_s2d(pre_gen, flow)
    4. out = Generator(pre, pre_warp)              -> (N, H, W, 48) s2d
    state': pre_gen' = out, last_frames' = [pre] + last_frames[:-1]

``apply`` is functional like the reference; the engine keeps the state
in fixed device tensors and commits ``new_state`` into them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.models.fnet import prepare_flow_resnet
from joshupscale_torch.models.generator import prepare_generator_resnet
from joshupscale_torch.ops.image import postprocess, preprocess
from joshupscale_torch.ops.space_depth import depth_to_space
from joshupscale_torch.ops.warp import dense_image_warp_s2d

State = Dict[str, Any]

# Options of the reference model that this port does not have yet, with
# the value that means "off" and the slice that brings them.
_LATER = {
    "flow_pad_factor": (None, "the PS2-family slice"),
    "normalize_brightness": (False, "the PS2-family slice"),
    "frame_moving_avg": (None, "the deployment-variants slice"),
    "output_flow": (False, "the deployment-variants slice"),
    "remove_flow": (False, "the deployment-variants slice"),
    "u8_state": (False, "the deployment-variants slice"),
}


@dataclasses.dataclass(frozen=True, eq=False)
class InferenceModel:
    """Functional recurrent VSR step (s2d serving form).

    ``flow_apply(params, frames, s2d_output=True)`` and
    ``generator_apply(params, frame, pre_warp, s2d_output=True)`` are the
    bound nets; they take the serving params ``prepare_params`` makes.
    ``compute_dtype`` is the networks' activation dtype.
    """

    flow_apply: Callable[..., torch.Tensor]
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

    def __post_init__(self):
        if not self.s2d_mode:
            raise NotImplementedError(
                "pixel mode (s2d_mode=False) is not ported yet; it waits "
                "for the pixel-mode slice")
        for name, (off, later) in _LATER.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"{name} is not ported yet; it waits for {later}")
        if self.num_flow_frames < 2:
            raise ValueError("flow num_inputs must be >= 2 (current frame "
                             "+ at least one last frame)")

    @property
    def num_last_frames(self) -> int:
        return self.num_flow_frames - 1

    def init_state(self, batch_size: int = 1, dtype=torch.float32,
                   device: DeviceLike = None) -> State:
        """Zero recurrent state: s2d ``pre_gen`` and the last-frames
        shift register (current frame first), on ``device`` (default:
        the CUDA device, as ``resolve_device`` reads it)."""
        device = resolve_device(device)
        h, w = self.frame_height, self.frame_width
        return {
            "pre_gen": torch.zeros((batch_size, h, w, 48), dtype=dtype,
                                   device=device),
            "last_frames": [
                torch.zeros((batch_size, h, w, 3), dtype=dtype,
                            device=device)
                for _ in range(self.num_last_frames)
            ],
        }

    def prepare_params(self, params, device) -> Dict[str, Any]:
        """Raw params -> the serving params ``apply`` takes, on
        ``device`` in ``compute_dtype``: every fold, cast and constant
        table of the step, made once ahead of serving, so a step copies
        nothing from the host."""
        def to_dev(tree):
            if isinstance(tree, dict):
                return {k: to_dev(v) for k, v in tree.items()}
            return tree.to(device)

        cdt = self.compute_dtype
        return {
            "flow": prepare_flow_resnet(to_dev(params["flow"]), cdt),
            "generator": prepare_generator_resnet(
                to_dev(params["generator"]), cdt),
        }

    def apply(self, params, cur_frame: torch.Tensor,
              state: State) -> Tuple[Dict[str, Any], State]:
        """One recurrent step on serving params (``prepare_params``):
        ``(outputs, new_state)``.

        ``outputs["output_s2d"]`` is the (N, H, W, 48) display tensor in
        s2d form.  Without ``deferred_display`` it also holds "output",
        the (N, 4H, 4W, 3) uint8 frame; with ``skip_processing``,
        "output_denorm", the float HR frame.
        """
        inter, flow_state = self.apply_flow_stage(
            params, cur_frame, {"last_frames": state["last_frames"]})
        outputs, gen_state = self.apply_gen_stage(
            params, inter, {"pre_gen": state["pre_gen"]})
        return outputs, {**gen_state, **flow_state}

    def apply_flow_stage(self, params, cur_frame: torch.Tensor,
                         state: State) -> Tuple[Dict[str, Any], State]:
        """Preprocess + flow net; returns ``{"pre", "flow"}`` and the
        new ``{"last_frames"}``."""
        cdt = self.compute_dtype
        pre = cur_frame if self.skip_processing else preprocess(cur_frame)
        pre = pre.to(cdt)
        last_frames = [f.to(cdt) for f in state["last_frames"]]
        flow = self.flow_apply(params["flow"], [pre] + last_frames,
                               s2d_output=True)
        new_state = {
            "last_frames": [pre.to(state["last_frames"][0].dtype)]
            + list(state["last_frames"][:-1]),
        }
        return {"pre": pre, "flow": flow}, new_state

    def apply_gen_stage(self, params, inter: Dict[str, Any],
                        state: State) -> Tuple[Dict[str, Any], State]:
        """Warp + generator; returns the outputs and ``{"pre_gen"}``."""
        cdt = self.compute_dtype
        pre_warp = dense_image_warp_s2d(state["pre_gen"].to(cdt),
                                        inter["flow"])
        out = self.generator_apply(params["generator"], inter["pre"],
                                   pre_warp, s2d_output=True)
        outputs = {"output_s2d": out}
        if self.skip_processing:
            outputs["output_denorm"] = depth_to_space(out, 4).float()
        elif not self.deferred_display:
            outputs["output"] = postprocess(depth_to_space(out, 4))
        return outputs, {"pre_gen": out.to(state["pre_gen"].dtype)}
