"""Serving engine: one recurrent upscale stream (or a batch of streams).

Port of ``Engine`` and ``create_runtime`` from
``joshupscale_tpu/runtime/engine.py``.  The recurrent state lives in
fixed device tensors updated in place: ``pre_gen`` is overwritten after
the generator has consumed its warp, and the last-frames shift register
is rotated (the oldest buffer takes the new frame and moves to the
front), so a frame copies one LR frame into the register and nothing
else.  The non-temporal variant (``remove_flow``) has no state.  With
deferred display (s2d mode) the step yields the s2d display tensor and
the engine converts it with the d2s+u8 kernel (``kernels/display.py``).

``process_async``, ``benchmark`` and ``debug_report`` are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.kernels.display import d2s_display_u8
from joshupscale_torch.models.inference import InferenceModel


class Engine:
    """One recurrent-upscale stream (or batch of streams) on a device.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.
    """

    def __init__(self, model: InferenceModel, params: Dict[str, Any],
                 batch_size: int = 1, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.batch_size = batch_size
        self.params = model.prepare_params(params, self.device)
        # As the reference's: only the s2d step emits the s2d display
        # tensor; the non-temporal step's output is the u8 HR frame.
        self._deferred = (model.deferred_display and model.s2d_mode
                          and not model.skip_processing
                          and not model.remove_flow)
        self.state = model.init_state(batch_size, device=self.device)
        self.frames_processed = 0
        self.total_process_seconds = 0.0

    # -- geometry ----------------------------------------------------------

    @property
    def input_shape(self):
        return (self.batch_size, self.model.frame_height,
                self.model.frame_width, 3)

    @property
    def output_shape(self):
        return (self.batch_size, self.model.frame_height * 4,
                self.model.frame_width * 4, 3)

    # -- streaming ---------------------------------------------------------

    def reset(self) -> None:
        """Restore the initial recurrent state (new stream / seek), in
        the engine's own buffers: ``init_state``'s values (zeros, or u8
        127 for a u8 state)."""
        fresh = self.model.init_state(self.batch_size, device=self.device)
        if not fresh:
            return
        self.state["pre_gen"].copy_(fresh["pre_gen"])
        for buf, init in zip(self.state["last_frames"],
                             fresh["last_frames"]):
            buf.copy_(init)

    def step(self, frame: torch.Tensor) -> torch.Tensor:
        """One recurrent step on a device frame (N, H, W, 3); returns the
        step's display tensor (s2d with deferred display) and commits the
        new state in place."""
        with torch.inference_mode():
            outputs, new_state = self.model.apply(self.params, frame,
                                                  self.state)
            if new_state:
                self.state["pre_gen"].copy_(new_state["pre_gen"])
                frames = self.state["last_frames"]
                oldest = frames[-1]
                oldest.copy_(new_state["last_frames"][0])
                self.state["last_frames"] = [oldest] + frames[:-1]
        if self._deferred:
            return outputs["output_s2d"]
        return outputs.get("output", outputs.get("output_denorm"))

    def display(self, out: torch.Tensor) -> torch.Tensor:
        """The display frame(s) of step output(s): d2s+u8 when deferred."""
        if self._deferred:
            return d2s_display_u8(out)
        return out

    def process(self, frame: np.ndarray) -> np.ndarray:
        """Blocking single-frame upscale: (H, W, 3) or (N, H, W, 3) u8."""
        start = time.perf_counter()
        squeeze = np.ndim(frame) == 3
        out = self.display(self.step(self._as_input(frame)))
        result = out.cpu().numpy()
        if squeeze:
            result = result[0]
        self.frames_processed += 1
        self.total_process_seconds += time.perf_counter() - start
        return result

    @property
    def avg_frame_seconds(self) -> float:
        """Mean blocking latency of process() calls so far."""
        if self.frames_processed == 0:
            return 0.0
        return self.total_process_seconds / self.frames_processed

    def process_clip(self, frames: np.ndarray,
                     chunk_frames: Optional[int] = None) -> np.ndarray:
        """Offline mode: (T, N, H, W, 3) or (T, H, W, 3) -> outputs.

        The step outputs of a chunk stay on the device and are displayed
        in one d2s+u8 launch on the stacked (T, N, Hb, Wb, 48) form;
        ``chunk_frames`` bounds how many frames a chunk holds (the state
        carries across chunks, so the result equals one pass).
        """
        frames = np.asarray(frames)
        squeeze = frames.ndim == 4
        if squeeze:
            frames = frames[:, None]
        if frames.shape[1:] != self.input_shape:
            raise ValueError(
                f"Invalid clip shape {frames.shape}; expected (T,) + "
                f"{self.input_shape}.  Load the package with "
                f"create_runtime(..., frame_size=(H, W)) to serve a "
                f"different size.")
        chunk = chunk_frames or max(len(frames), 1)
        parts = []
        for i in range(0, len(frames), chunk):
            outs = torch.stack([self.step(self._to_device(f))
                                for f in frames[i:i + chunk]])
            parts.append(self.display(outs).cpu().numpy())
        result = np.concatenate(parts, axis=0)
        return result[:, 0] if squeeze else result

    def _to_device(self, frame: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def _as_input(self, frame: np.ndarray) -> torch.Tensor:
        frame = np.asarray(frame)
        if frame.ndim == 3:
            frame = frame[None]
        if frame.shape != self.input_shape:
            raise ValueError(f"Invalid frame shape {frame.shape}; expected "
                             f"{self.input_shape}")
        return self._to_device(frame)


def create_runtime(model_path: str, device: DeviceLike = None,
                   batch_size: int = 1,
                   frame_size: Optional[Tuple[int, int]] = None) -> Engine:
    """Load a model package (``model.yaml`` + ``params.npz``, as the
    reference's ``save_package`` writes it) and build an engine.

    ``frame_size=(height, width)`` overrides the packaged LR frame size
    (the networks are fully convolutional).
    """
    from joshupscale_torch.export.package import load_package

    model, params = load_package(model_path)
    if frame_size is not None:
        model = dataclasses.replace(model, frame_height=frame_size[0],
                                    frame_width=frame_size[1])
    return Engine(model, params, batch_size=batch_size, device=device)
