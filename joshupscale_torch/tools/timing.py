"""Kernel timing on the card with CUDA events, and the card's name."""

from __future__ import annotations

import subprocess
from typing import Callable

import numpy as np
import torch


def cuda_time_ms(fn: Callable[[], object], reps: int, warmup: int = 3,
                 device_only: bool = True) -> float:
    """Median per-call time of ``fn`` on the card, CUDA events, after
    warm-up: 5 runs of ``reps`` calls each.

    ``device_only``: a spin kernel runs first so the host enqueues all
    ``reps`` calls while the card is still busy, and the events then
    time the calls back to back on the card, without host launch gaps.
    Without it the time includes whatever the host adds between calls.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms times the card; there is no CUDA "
                           "device")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(100_000_000)  # ~50 ms of spinning
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def busy_parts(events, group: Callable[[str], str]) -> dict:
    """The time the device was busy in a trace's kernel records
    ``events`` (``{"name", "ts", "dur"}``, µs), in ms, by
    ``group(name)``: each record counts from the later of its start and
    the end of every record that started before it.  A launch with
    programmatic dependent launch (K1 at C = 32) starts before the one it
    follows ends and waits; its overlap counts for the earlier one, so
    the parts sum to the busy time, not to the records' durations."""
    parts, end = {}, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        key = group(e["name"])
        parts[key] = (parts.get(key, 0.0)
                      + max(0.0, stop - max(start, end)) / 1e3)
        end = max(end, stop)
    return parts


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``): every time is stated beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()
