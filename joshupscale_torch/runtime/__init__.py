"""Serving runtime: engines with on-device recurrent state (a replayed
CUDA graph a frame on the card) and sequential video streams."""

from joshupscale_torch.runtime.engine import Engine, create_runtime
from joshupscale_torch.runtime.stream import VideoStream

__all__ = ["Engine", "create_runtime", "VideoStream"]
