"""Bytes ABI of the embedded-Python native runtime, over the port.

Port of ``joshupscale_tpu/runtime/native_glue.py``.  The C++ host
library (``native/src/python_backend.cc``) embeds CPython and talks to
an engine only through this interface, so the C++ side needs no NumPy
or PyTorch C API:

    eng = NativeEngine(model_path, device_id)
    out: bytes = eng.process_bytes(frame_bytes)   # HWC uint8 BGR

One frame in, one frame out, the recurrent state held on the device
inside the engine.  ``device_id`` is a CUDA device index; ``"cpu"``
serves on the CPU (the plain versions of the kernels).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from joshupscale_torch.runtime.engine import create_runtime


class NativeEngine:
    """Bytes-ABI wrapper over the port's Engine for the C++ host."""

    def __init__(self, model_path: str, device_id: Union[int, str] = 0,
                 batch_size: int = 1):
        if device_id != "cpu":
            n = torch.cuda.device_count()
            if not 0 <= device_id < n:
                raise ValueError(f"Invalid device {device_id}; {n} available")
        self.engine = create_runtime(model_path, device=device_id,
                                     batch_size=batch_size)
        model = self.engine.model
        self.input_width = model.frame_width
        self.input_height = model.frame_height
        self.output_width = model.frame_width * 4
        self.output_height = model.frame_height * 4
        self._in_nbytes = batch_size * self.input_height * self.input_width * 3

    def process_bytes(self, data: bytes) -> bytes:
        if len(data) != self._in_nbytes:
            raise ValueError(
                f"Expected {self._in_nbytes} bytes, got {len(data)}")
        frame = np.frombuffer(data, np.uint8).reshape(self.engine.input_shape)
        return np.ascontiguousarray(self.engine.process(frame)).tobytes()

    def reset(self) -> None:
        self.engine.reset()
