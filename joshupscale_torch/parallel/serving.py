"""Multi-stream serving: independent streams spread over devices.

Port of ``ShardedEngine`` from ``joshupscale_tpu/parallel/serving.py``.
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
from joshupscale_torch.runtime.engine import Engine


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
        for engine in self.engines:
            engine.reset()

    def process(self, frames: np.ndarray) -> np.ndarray:
        """One step for ALL streams: (B, H, W, 3) -> (B, 4H, 4W, 3).

        Every engine's step is enqueued before any output is copied
        back, so the devices run side by side."""
        frames = np.asarray(frames)
        if frames.shape != self.input_shape:
            raise ValueError(f"Invalid frames shape {frames.shape}; "
                             f"expected {self.input_shape}")
        s = self.streams_per_device
        outs = [engine._serve(engine._as_input(frames[i * s:(i + 1) * s]))
                for i, engine in enumerate(self.engines)]
        return np.concatenate([o.cpu().numpy() for o in outs])
