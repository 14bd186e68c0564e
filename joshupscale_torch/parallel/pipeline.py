"""Two-device pipelined serving: flow stage | generator stage.

Port of ``PipelinedEngine`` from ``joshupscale_tpu/parallel/pipeline.py``.
The flow net depends only on input frames (``InferenceModel
.apply_flow_stage``: the last-frames shift register never sees a
generator output), so flow(t+1) can run on one device while
warp + generator(t) runs on another.  ``devices[0]`` holds the flow
params and the shift register, ``devices[1]`` the generator params, the
``pre_gen`` feedback and the display; the inter-stage payload (the
preprocessed frame, the s2d flow head and, with brightness
normalization, the brightness) crosses once a frame.  With one device
for both stages the result is the same and nothing overlaps.

On CUDA each stage is one replayed CUDA graph (``capture_graph``, as
``Engine`` captures its frame).  The payload goes from the flow graph's
output buffers into fixed buffers on the generator's device, which the
generator graph reads, so every address stays put.  The generator
device's stream waits for the flow graph's frame, and the flow device's
stream waits for that copy before the next flow replay overwrites its
outputs.  Numerics are the single-device engine's: the same stages in
the same order on the same kernels, so stream and clip outputs equal
``Engine``'s bit for bit on one device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.kernels.display import d2s_display_u8
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.parallel.serving import cuda_devices
from joshupscale_torch.runtime.engine import (
    ServingIO,
    _deferred,
    capture_graph,
    clone_state,
    commit_state,
    copy_state,
    select_output,
)
from joshupscale_torch.runtime.spans import span


class PipelinedEngine(ServingIO):
    """One recurrent stream (or batch of streams) pipelined over two
    devices: ``process`` / ``process_async`` / ``process_clip`` /
    ``reset``, as ``runtime.engine.Engine`` (the host side is the same
    ``ServingIO``).  ``devices`` defaults to the first two CUDA devices
    (the first twice on a one-card host)."""

    def __init__(self, model: InferenceModel, params: Dict[str, Any],
                 batch_size: int = 1,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 max_inflight: int = 2) -> None:
        if model.remove_flow:
            raise ValueError(
                "remove_flow models have no flow stage to pipeline; "
                "use runtime.engine.Engine")
        if devices is None:
            cards = cuda_devices()
            devices = (cards[0], cards[1 % len(cards)])
        if len(devices) != 2:
            raise ValueError(f"need exactly 2 devices, got {len(devices)}")
        self.flow_device, self.gen_device = (resolve_device(d)
                                             for d in devices)
        self._init_io(model, batch_size, self.flow_device, self.gen_device,
                      max_inflight)
        self.flow_params = {"flow": model.prepare_net(
            "flow", params["flow"], self.flow_device)}
        self.gen_params = {"generator": model.prepare_net(
            "generator", params["generator"], self.gen_device)}
        self._deferred = _deferred(model)
        self.flow_state = {"last_frames": model.init_state(
            batch_size, device=self.flow_device)["last_frames"]}
        self.gen_state = {"pre_gen": model.init_state(
            batch_size, device=self.gen_device)["pre_gen"]}
        if self.flow_device.type == "cuda":
            if self.gen_device.type != "cuda":
                raise ValueError("both stages on CUDA devices, or both on "
                                 "the CPU")
            self._capture()

    # -- the stages ----------------------------------------------------------

    def _flow(self, frame: torch.Tensor, state) -> Dict[str, torch.Tensor]:
        inter, new_state = self.model.apply_flow_stage(
            self.flow_params, frame, state)
        commit_state(state, new_state)
        return inter

    def _gen(self, inter: Dict[str, torch.Tensor], state) -> torch.Tensor:
        outputs, new_state = self.model.apply_gen_stage(
            self.gen_params, inter, state)
        commit_state(state, new_state)
        out = select_output(self.model, outputs)
        return d2s_display_u8(out) if self._deferred else out

    def _capture(self) -> None:
        self._make_input()
        # The payload's shapes and dtypes, from one eager flow step on
        # scratch state.
        scratch = clone_state(self.flow_state)
        with torch.inference_mode():
            probe = self._flow(self._input, scratch)
        self._inter = {k: torch.zeros(v.shape, dtype=v.dtype,
                                      device=self.gen_device)
                       for k, v in probe.items()}
        del probe
        flow_graph, self._flow_out, flow_launches = capture_graph(
            self.flow_device, lambda: self._flow(self._input, scratch),
            lambda: self._flow(self._input, self.flow_state))
        gen_scratch = clone_state(self.gen_state)
        gen_graph, self._frame, gen_launches = capture_graph(
            self.gen_device, lambda: self._gen(self._inter, gen_scratch),
            lambda: self._gen(self._inter, self.gen_state))
        self._copied = torch.cuda.Event()
        self._graph = (flow_graph, gen_graph)
        self.graph_launches = {"flow": flow_launches, "generator":
                               gen_launches}

    def _before_input(self) -> None:
        # The last frame's payload (which may alias the input) has left
        # the flow device before anything there is overwritten.
        torch.cuda.current_stream().wait_event(self._copied)

    def _serve(self, frame: torch.Tensor) -> torch.Tensor:
        """Both stages on a flow-device frame: its display frame on the
        generator device (on CUDA the generator graph's buffer, valid
        until the next frame; the frame is already in the flow graph's
        input buffer)."""
        with span("engine.replay"):
            if self._graph is None:
                with torch.inference_mode():
                    inter = self._flow(frame, self.flow_state)
                    inter = {k: v.to(self.gen_device)
                             for k, v in inter.items()}
                    return self._gen(inter, self.gen_state)
            flow_graph, gen_graph = self._graph
            flow_stream = torch.cuda.current_stream(self.flow_device)
            gen_stream = torch.cuda.current_stream(self.gen_device)
            with torch.cuda.device(self.flow_device):
                flow_graph.replay()
                done = torch.cuda.Event()
                done.record(flow_stream)
            with torch.cuda.device(self.gen_device):
                gen_stream.wait_event(done)
                for k, buf in self._inter.items():
                    buf.copy_(self._flow_out[k], non_blocking=True)
                self._copied.record(gen_stream)
                gen_graph.replay()
            return self._frame

    # -- streaming ---------------------------------------------------------

    def reset(self) -> None:
        """Restore both stages' initial state (new stream / seek)."""
        with span("engine.reset"):
            self._drain()
            copy_state(self.flow_state, self.model.init_state(
                self.batch_size, device=self.flow_device))
            copy_state(self.gen_state, self.model.init_state(
                self.batch_size, device=self.gen_device))
