"""Serving over several devices: independent streams (``ShardedEngine``)
or one stream's frame split by rows (``SpatialEngine``).

Port of ``ShardedEngine`` and ``SpatialEngine`` from
``joshupscale_tpu/parallel/serving.py``.  ``ShardedEngine``:
The reference shards the stream (batch) dimension over a 1-D device mesh
and runs the single-stream program on every chip.  PyTorch has no mesh,
so this engine takes a list of devices and builds one ``Engine`` per
entry, each serving ``streams_per_device`` streams as one batch (on the
card: one frame graph per engine).  Streams are independent, so nothing
moves between devices.  A device may be listed more than once (several
engines on one card), and ``"cpu"`` entries run the plain versions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from joshupscale_torch import DeviceLike, resolve_device
from joshupscale_torch.kernels.display import d2s_display_u8
from joshupscale_torch.models.fnet import (
    flow_autoencoder_apply,
    flow_autoencoder_levels,
)
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.parallel.rows import Rows, Split, param_copies
from joshupscale_torch.runtime.engine import Engine, _deferred, select_output
from joshupscale_torch.runtime.spans import span


def cuda_devices() -> list:
    """Every visible CUDA device; raises where there is none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not count:
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(for example ['cpu', 'cpu']) to run the plain "
                           "PyTorch versions")
    return [torch.device("cuda", i) for i in range(count)]


class ShardedEngine:
    """N independent recurrent streams: ``streams_per_device`` on each
    entry of ``devices`` (default: every visible CUDA device)."""

    def __init__(self, model, params: Dict[str, Any],
                 devices: Optional[Sequence[DeviceLike]] = None,
                 streams_per_device: int = 1) -> None:
        devices = cuda_devices() if devices is None else devices
        self.model = model
        self.devices = [resolve_device(d) for d in devices]
        self.num_devices = len(self.devices)
        self.streams_per_device = streams_per_device
        self.batch_size = self.num_devices * streams_per_device
        self.engines = [Engine(model, params, batch_size=streams_per_device,
                               device=d) for d in self.devices]

    @property
    def input_shape(self):
        return (self.batch_size, self.model.frame_height,
                self.model.frame_width, 3)

    def reset(self) -> None:
        with span("engine.reset"):
            for engine in self.engines:
                engine.reset()

    def process(self, frames: np.ndarray) -> np.ndarray:
        """One step for ALL streams: (B, H, W, 3) -> (B, 4H, 4W, 3).

        Every engine's step is enqueued before any output is copied
        back, so the devices run side by side."""
        with span("engine.process"):
            frames = np.asarray(frames)
            if frames.shape != self.input_shape:
                raise ValueError(f"Invalid frames shape {frames.shape}; "
                                 f"expected {self.input_shape}")
            s = self.streams_per_device
            outs = [engine._serve(engine._as_input(frames[i * s:(i + 1) * s]))
                    for i, engine in enumerate(self.engines)]
            with span("engine.readback"):
                return np.concatenate([o.cpu().numpy() for o in outs])


def _canonical(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class SpatialEngine:
    """ONE stream's frame split by rows over ``devices`` (latency mode):
    slab ``i`` of every activation and of the recurrent state lives on
    ``devices[i]`` (default: every visible CUDA device; a device may be
    listed more than once, ``"cpu"`` entries run the plain versions).

    The counterpart of the reference's ``SpatialEngine``, where GSPMD
    shards H over a mesh, inserts the convs' halo exchanges and
    all-gathers what the warp reads.  Here the step is
    ``InferenceModel.apply`` with ``parallel.rows.Rows`` as its layer
    rules: each 3x3 conv -- K1 included, launched on slab plus halo --
    takes one halo row from each neighbour, the x2 / x4 bilinear
    upscales one from below, and the rest of the step is row-local,
    except:

    - the warp reads the whole previous output: ``pre_gen`` (the u8
      table on the u8-state tier) is gathered onto each device once a
      frame, and each slab's warp uses its global rows;
    - layers with no row-local form run whole on the first device and
      scatter their output: the brightness mean, the frame moving
      average, and every int8 conv and int8 res block (their activation
      scale is the whole tensor's absmax).

    Slab boundaries are LR rows (s2d mode works on the LR grid).  The
    flow net's rows (``flow_split``) are split on the padded grid, on
    multiples of its pooling factor (the autoencoder's ``2 ** levels``),
    as evenly as that allows; the frame's slabs (``split``) are the flow
    slabs less the padding rows, so the first slab gives up the top
    padding and the last the bottom.  With deferred display each slab
    runs K2.  Steps run eagerly (no CUDA graph); a failed copy or launch
    raises.  ``process`` and ``reset`` behave as the reference's.
    ``taps``: set to a dict to keep every layer's gathered output of the
    next steps by name.
    """

    def __init__(self, model: InferenceModel, params: Dict[str, Any],
                 devices: Optional[Sequence[DeviceLike]] = None) -> None:
        devices = cuda_devices() if devices is None else devices
        self.model = model
        self.devices = [_canonical(resolve_device(d)) for d in devices]
        self.num_devices = n = len(self.devices)
        self._deferred = _deferred(model)
        self.taps: Optional[Dict[str, torch.Tensor]] = None
        h = model.frame_height
        top, bottom = model.padding[:2]
        factor = 1
        if getattr(model.flow_apply, "func", None) is flow_autoencoder_apply:
            factor = 2 ** flow_autoencoder_levels(params["flow"])
        units = (h + top + bottom) // factor
        self.split = Split(
            [0] + [factor * (i * units // n) - top for i in range(1, n)]
            + [h], self.devices)
        self.flow_split = self.split.padded(top, bottom)
        prepared: Dict[torch.device, Any] = {}
        for d in self.devices:
            if d not in prepared:
                prepared[d] = model.prepare_params(params, d)
        self.params = [prepared[d] for d in self.devices]
        self.rows = Rows(self.split, param_copies(self.params), self._tap)
        self.frames_processed = 0
        self.reset()

    def _tap(self, name: str, whole) -> None:
        if self.taps is not None:
            self.taps[name] = whole()

    @property
    def input_shape(self):
        return (1, self.model.frame_height, self.model.frame_width, 3)

    @property
    def output_shape(self):
        return (1, self.model.frame_height * 4, self.model.frame_width * 4,
                3)

    def reset(self) -> None:
        """Restore ``init_state`` (new stream / seek), split by rows:
        ``pre_gen`` on the frame's slabs (of the HR grid in pixel
        mode), the last frames on the flow net's."""
        with span("engine.reset"):
            state = self.model.init_state(1, device="cpu")
            if not state:
                self.state = {}
                return
            pre_split = (self.split if self.model.s2d_mode
                         else self.split.scaled(4))
            self.state = {
                "pre_gen": pre_split.scatter(state["pre_gen"]),
                "last_frames": [self.flow_split.scatter(f)
                                for f in state["last_frames"]],
            }

    def process(self, frame: np.ndarray) -> np.ndarray:
        """One frame, (H, W, 3) or (1, H, W, 3) u8 (float with
        ``skip_processing``) -> the (4H, 4W, 3) display frame."""
        with span("engine.process"), torch.inference_mode():
            with span("engine.stage_copy"):
                frame = np.asarray(frame)
                if frame.ndim == 3:
                    frame = frame[None]
                if frame.shape != self.input_shape:
                    raise ValueError(f"Invalid frame shape {frame.shape}; "
                                     f"expected {self.input_shape}")
            with span("engine.h2d"):
                slabs = self.split.scatter(torch.from_numpy(frame))
            with span("engine.replay"):
                outputs, self.state = self.model.apply(
                    self.params[0], slabs, self.state, self.rows)
                out = select_output(self.model, outputs)
                if self._deferred:
                    out = self.rows.map(d2s_display_u8, out)
            with span("engine.readback"):
                result = np.concatenate([o.cpu().numpy() for o in out],
                                        axis=1)
            self.frames_processed += 1
            return result[0]
