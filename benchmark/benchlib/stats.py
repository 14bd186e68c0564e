"""Percentiles over every sample (numpy's linear interpolation, as the
port's latency probe takes them)."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear interpolation)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(latencies_s, streams: int, window_s: float,
               setup_s: float) -> dict:
    """The window's end-to-end metrics: ``fps``, every display frame
    completed over the window's seconds; ``frame_ms.p95``, the 95th
    percentile over every frame (each frame of a batched call takes the
    call's latency); ``setup_s``."""
    frames = np.repeat(np.asarray(latencies_s, np.float64), streams)
    return {
        "fps": {"value": len(frames) / window_s, "unit": "frames/s"},
        "frame_ms.p95": {"value": percentile(frames, 95) * 1e3,
                         "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
