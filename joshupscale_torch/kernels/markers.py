"""Stage markers: empty kernels that mark the ends of a frame's stages
in a profiler trace.

A replayed CUDA graph carries no op ranges, so the trace of a frame
graph cannot put its kernels down to a stage.  ``runtime.engine.Engine``
replays, while a ``torch.profiler`` session is active, a second frame
graph captured with ``models.common.STAGE_MARKS`` as its layer rules,
which launch ``stage_end_flow`` after the flow net, ``stage_end_warp``
after the warp and ``stage_end_generator`` after the generator (and the
moving average).  The state commit and the display come after the last
marker.  CUDA source ``csrc/stage_markers.cu``: each kernel is
``<<<1, 1>>>`` on the current stream and touches no data, so the marked
graph's frames are the plain graph's, bit for bit.

``stage_end`` launches nothing for a CPU tensor (the plain step has no
device timeline to mark) nor under ``torch.export``'s tracing, so no
exported artifact holds a marker.  ``stage_end.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from joshupscale_torch.kernels import _build

MARKERS = ("stage_end_flow", "stage_end_warp", "stage_end_generator")
STAGES = {"flow": 0, "pre_warp": 1, "output": 2}
"""The ``record`` names of ``InferenceModel``'s stage boundaries, and
the marker each ends with."""


def _lib() -> ctypes.CDLL:
    lib = _build.load("stage_markers")
    lib.jt_stage_markers.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.jt_stage_markers.restype = ctypes.c_int
    return lib


def stage_end(which: int, x: torch.Tensor) -> torch.Tensor:
    """Launch marker ``MARKERS[which]`` on the current stream of ``x``'s
    device and return ``x`` (nothing on the CPU or while tracing)."""
    if x.device.type != "cuda" or _build.tracing(x):
        return x
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib, lib.jt_stage_markers(which, stream), MARKERS[which])
    stage_end.launches += 1
    return x


stage_end.launches = 0
