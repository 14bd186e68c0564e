"""Serving engine: one recurrent upscale stream (or a batch of streams).

Port of ``Engine`` and ``create_runtime`` from
``joshupscale_tpu/runtime/engine.py``.

The recurrent state lives in fixed device tensors committed in place
(``commit_state``): ``pre_gen`` is overwritten after the generator has
consumed its warp, and the last-frames shift register shifts in place
(each buffer takes the next newer one's frame, oldest first, then the
newest takes the new frame), so no state tensor is ever rebound and
``reset`` copies ``init_state`` into the same tensors.  The
non-temporal variant (``remove_flow``) has no state.

On a CUDA device a frame is one replayed CUDA graph, the counterpart of
the reference's jitted step with donated state.  The engine captures it
once, when it is built (``capture_graph``, which the pipelined engine
uses for its two stages too): warm-up frames run first on a side
stream, on scratch copies of the state (so the recurrence does not
move), which
also runs every kernel's one-time host set-up (shared-memory opt-in,
grid size, the tensor-map encoder's lookup) and fills the per-device
constant caches of the ops; then ``run_step`` (``model.apply`` and the
in-place state commit) and, with deferred display (s2d mode), the
d2s+u8 kernel (``kernels/display.py``) are captured.  Every tensor the
graph reads or writes keeps its address across replays -- the input
frame buffer, the state, the prepared params, the cached constants and
the graph's own pool, which holds the step output and the u8 frame --
since the res-block kernel's TMA descriptors are encoded from the
addresses at capture.  A frame copies into the input buffer and replays
the graph; a failed capture raises, with no eager fallback.  On the CPU
the same functions run eagerly.  The host side (the frame checks, the
pinned staging ring, ``process`` / ``process_async`` / ``process_clip``)
is ``ServingIO``, which the pipelined engine shares.

Profiling: every call opens the host spans of ``runtime/spans.py``
while a ``torch.profiler`` session is active.  A replay made then runs a
second frame graph, captured with the plain one on the same input buffer
and state: the same step with an empty marker kernel at the end of the
flow net, the warp and the generator (``kernels/markers.py``), so the
trace can put the graph's kernels down to a stage.  Its frames are the
plain graph's, bit for bit.  Replays made with the profiler off, or
inside ``spans.unmarked()``, run the plain graph only.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.kernels import launch_counts
from joshupscale_torch.kernels.display import d2s_display_u8
from joshupscale_torch.kernels.markers import MARKERS, stage_end
from joshupscale_torch.models.common import (
    STAGE_MARKS,
    WHOLE_FRAME,
    WholeFrame,
)
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.runtime.spans import marking, span

WARMUP_STEPS = 3  # eager frames before the capture (torch's own default)
BUILD_STEPS = WARMUP_STEPS + 2
"""Steps through the kernel wrappers that an engine's construction on the
card makes: the eager warm-up, the plain and the marked graph's
capture."""


def clone_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a recurrent state, or of one stage's part of it (empty
    stays empty)."""
    out = {}
    if "pre_gen" in state:
        out["pre_gen"] = state["pre_gen"].clone()
    if "last_frames" in state:
        out["last_frames"] = [f.clone() for f in state["last_frames"]]
    return out


def copy_state(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy ``src``'s values into ``dst``'s tensors, in place (``dst``'s
    keys: a whole state or one stage's part)."""
    if "pre_gen" in dst:
        dst["pre_gen"].copy_(src["pre_gen"])
    for buf, value in zip(dst.get("last_frames", ()),
                          src.get("last_frames", ())):
        buf.copy_(value)


def commit_state(state: Dict[str, Any], new_state: Dict[str, Any]) -> None:
    """Commit ``apply``'s (or a stage's) new state into ``state``'s
    tensors in place.

    ``new_state["last_frames"]`` is the new frame followed by the old
    register's first buffers, so the register shifts: oldest buffer
    first, each takes its newer neighbour's frame, then the newest takes
    the new frame.  A captured graph can replay this; a rotation of the
    Python list could not.
    """
    if "pre_gen" in new_state:
        state["pre_gen"].copy_(new_state["pre_gen"])
    if "last_frames" in new_state:
        frames = state["last_frames"]
        for k in range(len(frames) - 1, 0, -1):
            frames[k].copy_(frames[k - 1])
        frames[0].copy_(new_state["last_frames"][0])


def capture_graph(device: torch.device, warm_up: Callable[[], Any],
                  body: Callable[[], Any], pool=None):
    """A CUDA graph of ``body()`` on ``device``: ``warm_up()`` runs
    ``WARMUP_STEPS`` times eagerly on a side stream first (each kernel's
    one-time host set-up, the ops' constant caches), then ``body()`` is
    captured (into the memory pool ``pool``, a graph's ``pool()``, if
    given).  Returns ``(graph, body's result, kernel launches recorded
    into the graph by wrapper name)``; a failed capture raises."""
    with torch.cuda.device(device):
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(WARMUP_STEPS):
                warm_up()
        main.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph, pool=pool):
            result = body()
        after = launch_counts()
    return graph, result, {k: after[k] - before[k] for k in after}


def run_step(model: InferenceModel, params, frame: torch.Tensor,
             state: Dict[str, Any], ops: WholeFrame = WHOLE_FRAME
             ) -> torch.Tensor:
    """One eager recurrent step: ``model.apply`` on serving params (with
    the layer rules ``ops``), the new state committed into ``state`` in
    place; returns the step's display tensor (s2d with deferred display,
    else the u8 frame, or the float frame with ``skip_processing``)."""
    outputs, new_state = model.apply(params, frame, state, ops)
    commit_state(state, new_state)
    return select_output(model, outputs)


def select_output(model: InferenceModel, outputs: Dict[str, Any]):
    """The step's display tensor among ``apply``'s (or the generator
    stage's) outputs: s2d with deferred display, else the u8 frame, or
    the float frame with ``skip_processing``."""
    if _deferred(model):
        return outputs["output_s2d"]
    return outputs.get("output", outputs.get("output_denorm"))


def _deferred(model: InferenceModel) -> bool:
    # As the reference's: only the s2d step emits the s2d display
    # tensor; the non-temporal step's output is the u8 HR frame.
    return (model.deferred_display and model.s2d_mode
            and not model.skip_processing and not model.remove_flow)


class ServingIO:
    """The host side of serving, shared by ``Engine`` and
    ``parallel.pipeline.PipelinedEngine``: the frame checks, the pinned
    staging ring that feeds the graph's input buffer, ``process``,
    ``process_async`` (at most ``max_inflight`` frames in flight) and
    ``process_clip``.  A subclass calls ``_init_io`` first, makes its
    input buffer with ``_make_input`` before it captures, sets
    ``_graph`` once captured, and defines ``_serve``."""

    def _init_io(self, model: InferenceModel, batch_size: int,
                 in_device: torch.device, out_device: torch.device,
                 max_inflight: int) -> None:
        self.model = model
        self.batch_size = batch_size
        self._in_device = in_device  # holds the graph's input buffer
        self._out_device = out_device  # makes the display frame
        self._max_inflight = max_inflight
        self._pending: "collections.deque" = collections.deque()
        self._graph = None  # the captured graph(s); None on the CPU
        self.frames_processed = 0
        self.total_process_seconds = 0.0

    @property
    def input_shape(self):
        return (self.batch_size, self.model.frame_height,
                self.model.frame_width, 3)

    @property
    def output_shape(self):
        return (self.batch_size, self.model.frame_height * 4,
                self.model.frame_width * 4, 3)

    def _make_input(self) -> None:
        dtype = torch.float32 if self.model.skip_processing else torch.uint8
        with torch.cuda.device(self._in_device):
            # Written by the host and by the graph: made outside
            # inference mode, like the state.
            self._input = torch.zeros(self.input_shape, dtype=dtype,
                                      device=self._in_device)
            # Pinned staging ring for host frames: a buffer is refilled
            # only once its previous copy has completed.
            self._staging = [
                (torch.empty(self.input_shape, dtype=dtype,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(self._max_inflight + 1)]
        self._slot = 0

    def _serve(self, frame: torch.Tensor) -> torch.Tensor:
        """One step on a device frame and its display frame (N, 4H, 4W,
        3); with a graph, the graph's buffer, valid until the next
        step."""
        raise NotImplementedError

    def _before_input(self) -> None:
        """Enqueued on the input device's stream before a frame
        overwrites the input buffer: what must finish first."""

    def process_async(self, frame: np.ndarray) -> torch.Tensor:
        """Enqueue one frame ((H, W, 3) or (N, H, W, 3) u8) and return its
        display frame (N, 4H, 4W, 3) on the device without waiting.

        The tensor is the frame's own (no later step overwrites it); it
        is ready once the device reaches it (``.cpu()`` waits).  At most
        ``max_inflight`` frames are in flight: past that the call waits
        for the oldest.
        """
        with span("engine.process"):
            out = self._serve(self._as_input(frame))
            if self._graph is not None:
                # the graph's buffer: the next replay reuses it
                out = out.clone()
            self._pending.append(self._record())
            while len(self._pending) > self._max_inflight:
                self._wait(self._pending.popleft())
            return out

    def process(self, frame: np.ndarray) -> np.ndarray:
        """Blocking single-frame upscale: (H, W, 3) or (N, H, W, 3) u8."""
        with span("engine.process"):
            start = time.perf_counter()
            out = self._serve(self._as_input(frame))
            with span("engine.readback"):
                result = out.cpu().numpy()
                if np.ndim(frame) == 3:
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

        Each frame's display frame is copied out of the step's buffer
        into a (T, N, 4H, 4W, 3) device buffer before the next step;
        ``chunk_frames`` bounds how many frames that buffer holds (the
        state carries across chunks, so the result equals one pass).
        """
        self._drain()
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
        with torch.inference_mode():
            for i in range(0, len(frames), chunk):
                part, outs = frames[i:i + chunk], None
                for t, f in enumerate(part):
                    out = self._serve(self._as_input(f))
                    if outs is None:
                        outs = out.new_empty((len(part),) + tuple(out.shape))
                    outs[t].copy_(out)
                parts.append(outs.cpu().numpy())
        result = np.concatenate(parts, axis=0)
        return result[:, 0] if squeeze else result

    def _as_input(self, frame: np.ndarray) -> torch.Tensor:
        if self._graph is None:
            with span("engine.stage_copy"):
                return torch.tensor(self._checked(frame),
                                    device=self._in_device)
        # Through the next pinned staging buffer into the graph's input
        # buffer, without blocking the host.
        buf, copied = self._staging[self._slot]
        self._slot = (self._slot + 1) % len(self._staging)
        with span("engine.stage_wait"):
            copied.synchronize()
        with span("engine.stage_copy"):
            buf.numpy()[...] = self._checked(frame)
        with span("engine.h2d"), torch.cuda.device(self._in_device):
            self._before_input()
            self._input.copy_(buf, non_blocking=True)
            copied.record()
        return self._input

    def _checked(self, frame: np.ndarray) -> np.ndarray:
        """``frame`` as an (N, H, W, 3) array; raises on another shape."""
        frame = np.asarray(frame)
        if frame.ndim == 3:
            frame = frame[None]
        if frame.shape != self.input_shape:
            raise ValueError(f"Invalid frame shape {frame.shape}; expected "
                             f"{self.input_shape}")
        return frame

    def _record(self):
        """An event after the work enqueued so far (None on the CPU,
        where the work is done when the call returns)."""
        if self._graph is None:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._out_device))
        return event

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            event.synchronize()

    def _drain(self) -> None:
        while self._pending:
            self._wait(self._pending.popleft())


class Engine(ServingIO):
    """One recurrent-upscale stream (or batch of streams) on a device.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernels.  On
    CUDA the constructor builds the kernels and captures the frame graph
    (see the module docstring).  ``max_inflight`` bounds how many
    ``process_async`` frames may be in flight.
    """

    def __init__(self, model: InferenceModel, params: Dict[str, Any],
                 batch_size: int = 1, device: DeviceLike = None,
                 max_inflight: int = 2) -> None:
        self.device = resolve_device(device)
        self._init_io(model, batch_size, self.device, self.device,
                      max_inflight)
        self.params = model.prepare_params(params, self.device)
        self._deferred = _deferred(model)
        self.state = model.init_state(batch_size, device=self.device)
        # Kernel launches recorded into the graph, by wrapper name.
        self.graph_launches: Dict[str, int] = {}
        if self.device.type == "cuda":
            self._capture()

    # -- the CUDA graph ----------------------------------------------------

    def _capture(self) -> None:
        self._make_input()
        scratch = clone_state(self.state)
        self._graph, (self._out, self._frame), self.graph_launches = \
            capture_graph(self.device, lambda: self._frame_step(scratch),
                          lambda: self._frame_step(self.state))
        self._capture_marked()

    def _frame_step(self, state, ops: WholeFrame = WHOLE_FRAME):
        out = run_step(self.model, self.params, self._input, state, ops)
        return out, self.display(out)

    def _capture_marked(self) -> None:
        """The marked frame graph: the same step with a stage marker at
        each stage's end (``STAGE_MARKS``), on the same input buffer and
        state, in the plain graph's memory pool (the two never run at
        once, and each one's outputs are valid only until the next
        step).  Its warm-up launches only the markers (building them):
        everything else was warmed for the plain graph.  Raises unless
        it records the plain graph's kernel launches.

        It is captured with the plain graph, before any profiler session
        can start: a graph instantiated while the profiler's CUPTI is
        attached runs its copy and memset nodes as copies and memsets,
        where one instantiated before runs them as kernels (on an H100,
        26 µs a frame of the quality step), so a marked graph captured
        later would not trace as the plain graph runs."""
        graph, outs, launches = capture_graph(
            self.device,
            lambda: [stage_end(i, self._input) for i in range(len(MARKERS))],
            lambda: self._frame_step(self.state, STAGE_MARKS),
            pool=self._graph.pool())
        if launches != self.graph_launches:
            raise RuntimeError(f"the marked frame graph recorded {launches} "
                               f"kernel launches, the plain one "
                               f"{self.graph_launches}")
        self._marked = (graph,) + outs

    def _replay(self, frame: torch.Tensor):
        """Replay the frame graph on ``frame`` (the marked graph while
        ``spans.marking()``): its (step output, display frame)
        buffers."""
        if frame is not self._input:
            if tuple(frame.shape) != self.input_shape:
                raise ValueError(f"Invalid frame shape {tuple(frame.shape)}; "
                                 f"expected {self.input_shape}")
            self._input.copy_(frame)
        graph, out, shown = self._marked if marking() else (
            self._graph, self._out, self._frame)
        with torch.cuda.device(self.device):
            graph.replay()
        return out, shown

    # -- streaming ---------------------------------------------------------

    def reset(self) -> None:
        """Restore the initial recurrent state (new stream / seek), in
        the engine's own buffers: ``init_state``'s values (zeros, or u8
        127 for a u8 state)."""
        with span("engine.reset"):
            self._drain()
            copy_state(self.state, self.model.init_state(
                self.batch_size, device=self.device))

    def step(self, frame: torch.Tensor) -> torch.Tensor:
        """One recurrent step on a device frame (N, H, W, 3); returns the
        step's display tensor (s2d with deferred display) and commits the
        new state in place.

        On CUDA this replays the frame graph (the display included) and
        returns the graph's output buffer: it holds this step's output
        only until the next step or frame of the engine overwrites it.
        """
        with span("engine.replay"):
            if self._graph is None:
                return self._eager(frame)
            return self._replay(frame)[0]

    def _eager(self, frame: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return run_step(self.model, self.params, frame, self.state)

    def display(self, out: torch.Tensor) -> torch.Tensor:
        """The display frame(s) of step output(s): d2s+u8 when deferred."""
        if self._deferred:
            return d2s_display_u8(out)
        return out

    def _serve(self, frame: torch.Tensor) -> torch.Tensor:
        with span("engine.replay"):
            if self._graph is None:
                return self.display(self._eager(frame))
            return self._replay(frame)[1]

    # -- profiling ---------------------------------------------------------

    def debug_report(self) -> Dict[str, Any]:
        """The step's operations by name (the counterpart of the
        reference's compiled-program report): the ATen ops that one
        eager ``model.apply``, its state commit and, where deferred, its
        display dispatch on a zero frame and a scratch copy of the state
        (counted with a ``TorchDispatchMode``), plus the port's kernels
        by wrapper name with their launches in that run (on the CPU a
        wrapper runs its plain version, whose ATen ops count instead).
        Also the input and output shapes.  The engine's state is not
        touched.  There is no compiler cost analysis here, so the report
        has no ``cost_analysis``, as the reference's has none when its
        compiler offers none.
        """
        from torch.utils._python_dispatch import TorchDispatchMode

        ops: "collections.Counter[str]" = collections.Counter()

        class _CountOps(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops[str(func.overloadpacket)] += 1
                return func(*args, **(kwargs or {}))

        dtype = torch.float32 if self.model.skip_processing else torch.uint8
        frame = torch.zeros(self.input_shape, dtype=dtype, device=self.device)
        scratch = clone_state(self.state)
        before = launch_counts()
        with torch.inference_mode(), _CountOps():
            self.display(run_step(self.model, self.params, frame, scratch))
        for name, n in launch_counts().items():
            if n > before[name]:
                ops[name] += n - before[name]
        return {
            "instruction_counts": dict(ops.most_common()),
            "num_instructions": sum(ops.values()),
            "input_shape": list(self.input_shape),
            "output_shape": list(self.output_shape),
        }

    def benchmark(self, num_frames: int = 96, warmup: int = 16,
                  method: str = "scan_diff") -> Dict[str, Any]:
        """Measure per-frame throughput/latency; returns a dict.

        ``method="scan_diff"`` (default): frames run back to back (graph
        replays, display included, timed with CUDA events on the card;
        eager steps on a ``perf_counter`` on the CPU) from a fresh
        ``init_state``, and the per-frame time is the difference between
        a ``num_frames`` clip and a short clip over the difference in
        frames.  The engine's state is restored afterwards.  Returns
        {"mean", "frame_ms", "fps", "method"}.

        ``method="per_dispatch"``: wall-clocks each frame's round trip
        (host -> device copy, step, display, wait) after ``warmup``
        ``process`` calls and reports p50/p99; it advances the state, as
        the reference's does.  Returns {"p50", "p99", "mean", "fps",
        "method"}.
        """
        rng = np.random.default_rng(0)
        dt = np.float32 if self.model.skip_processing else np.uint8
        if method == "scan_diff":
            short = max(4, num_frames // 6)
            if num_frames <= short:
                # Differencing needs two distinct clip lengths.
                raise ValueError(
                    f"scan_diff needs num_frames > {short} "
                    f"(got {num_frames}); use method='per_dispatch' "
                    f"for short runs")
            self._drain()
            saved = clone_state(self.state)
            try:
                t_short = self._clip_seconds(short, rng, dt)
                t_long = self._clip_seconds(num_frames, rng, dt)
            finally:
                copy_state(self.state, saved)
            per = (t_long - t_short) / (num_frames - short)
            return {
                "mean": float(per),
                "frame_ms": float(per * 1e3),
                "fps": float(1.0 / per) * self.batch_size,
                "method": "scan_diff",
            }
        if method != "per_dispatch":
            raise ValueError(f"unknown benchmark method {method!r}")
        frame = rng.integers(0, 256, self.input_shape,
                             dtype=np.uint8).astype(dt)
        for _ in range(warmup):
            self.process(frame)
        times = []
        for _ in range(num_frames):
            t0 = time.perf_counter()
            self._serve(self._as_input(frame))
            if self._graph is not None:
                torch.cuda.synchronize(self.device)
            times.append(time.perf_counter() - t0)
        times = np.asarray(times)
        return {
            "p50": float(np.percentile(times, 50)),
            "p99": float(np.percentile(times, 99)),
            "mean": float(times.mean()),
            "fps": float(1.0 / np.percentile(times, 50)) * self.batch_size,
            "method": "per_dispatch",
        }

    def _clip_seconds(self, t: int, rng, dt, reps: int = 3) -> float:
        """Seconds of ``t`` frames back to back from ``init_state`` (the
        state reset counts in every clip alike), after one warm run."""
        frames = torch.from_numpy(rng.integers(
            0, 256, (t,) + self.input_shape, np.uint8).astype(dt)).to(
                self.device)
        init = self.model.init_state(self.batch_size, device=self.device)

        def clip():
            copy_state(self.state, init)
            for f in frames:
                self._serve(f)

        with torch.inference_mode():
            clip()
            if self._graph is None:
                t0 = time.perf_counter()
                for _ in range(reps):
                    clip()
                return (time.perf_counter() - t0) / reps
            with torch.cuda.device(self.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    clip()
                end.record()
                end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps


def create_runtime(model_path: str, device: DeviceLike = None,
                   batch_size: int = 1,
                   frame_size: Optional[Tuple[int, int]] = None) -> Engine:
    """Load a model package (``model.yaml`` + ``params.npz``, as either
    package's ``save_package`` writes it) and build an engine.

    ``frame_size=(height, width)`` overrides the packaged LR frame size
    (the networks are fully convolutional).
    """
    from joshupscale_torch.export.package import load_package

    model, params = load_package(model_path)
    if frame_size is not None:
        model = dataclasses.replace(model, frame_height=frame_size[0],
                                    frame_width=frame_size[1])
    return Engine(model, params, batch_size=batch_size, device=device)
