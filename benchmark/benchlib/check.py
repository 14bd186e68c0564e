"""Whether the timed path served the right frames.

The window's stream is cut into shots of ``shot_frames`` frames (the
engine's recurrent state is reset at each cut).  The mix's ``check``
entry says how many shots (``shots``) are drawn from the seed among the
``shots_among`` shots from ``first_shot`` (after the traced stretch, so
that no copy for the check falls inside it), and which of their frames are kept for the check
(every ``every``-th from the shot's first, and its last, the longest
recurrence).  The frames the timed path returned for those calls are
copied into a host buffer made during set-up, after each call's latency
is taken.  Once the window has closed, the program freed and the peak
memory read, the plain reference runs each drawn shot from its first
frame with the same frames and weights (float32, TF32 off) and the kept
frames are compared, u8 for u8:

- ``mean_abs_u8``: the mean |served - reference| over every kept frame's
  pixels and channels;
- ``worst_frame_mean_abs_u8``: the largest such mean of one frame of one
  stream.

Each number is held to the cell's limit (``benchmark/limits/<cell>.json``).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch


def kept_calls(mix: dict, seed: int) -> Dict[int, int]:
    """{call index in the window: slot of the host buffer} of the frames
    kept for the check: every ``every``-th frame and the last of
    ``shots`` shots drawn from ``seed`` among ``shots_among`` from
    ``first_shot``."""
    chk, shot = mix["check"], int(mix["shot_frames"])
    rng = np.random.default_rng([int(seed) % (1 << 63), 20])
    drawn = rng.choice(int(chk["shots_among"]), int(chk["shots"]),
                       replace=False)
    shots = sorted(int(chk["first_shot"]) + int(k) for k in drawn)
    positions = sorted(set(range(0, shot, int(chk["every"]))) | {shot - 1})
    calls = [k * shot + p for k in shots for p in positions]
    return {c: i for i, c in enumerate(calls)}


def reference_frames(reference, models: dict, params, ring: np.ndarray,
                     mix: dict, kept: Dict[int, int], device,
                     rounding=None) -> Tuple[np.ndarray, dict]:
    """The kept calls' display frames as the reference serves them, each
    drawn shot run from its first frame (``rounding``: through a lower
    precision, the control), in the layout of the timed path's kept
    frames; and notes: the reference's steps and the mean |flow| in LR
    pixels a frame."""
    reference.no_tf32()
    ref = reference.Reference(models, params, device, rounding=rounding)
    shot = int(mix["shot_frames"])
    out = np.zeros((len(kept),) + ring.shape[1:2] + tuple(
        4 * s for s in ring.shape[2:4]) + (3,), np.uint8)
    steps, flow_sum = 0, 0.0
    with torch.no_grad():
        for k in sorted({c // shot for c in kept}):
            state = ref.init_state(ring.shape[1])
            last = max(c for c in kept if c // shot == k)
            for c in range(k * shot, last + 1):
                frame = torch.from_numpy(ring[c % len(ring)]).to(device)
                display, state, flow = ref.step(frame, state)
                flow_sum += float(flow.norm(dim=-1).mean()) / 4
                steps += 1
                if c in kept:
                    out[kept[c]] = display.cpu().numpy()
    return out, {"reference_steps": steps,
                 "mean_abs_flow_lr_px": flow_sum / max(steps, 1)}


def compare(reference, models: dict, params, ring: np.ndarray, mix: dict,
            kept: Dict[int, int], served: np.ndarray, device
            ) -> Tuple[Dict[str, float], dict]:
    """The float32 reference's frames for the kept calls against
    ``served``: ``(numbers, notes)``, the notes with each compared
    frame's mean (one a stream) and the reference's seconds."""
    t0 = time.monotonic()
    want, notes = reference_frames(reference, models, params, ring, mix,
                                   kept, device)
    per_frame, total = [], 0
    for got, ref in zip(served, want):  # a call's frames at a time
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        per_frame += diff.reshape(len(diff), -1).mean(axis=1).tolist()
        total += int(diff.sum())
    numbers = {"mean_abs_u8": total / served.size,
               "worst_frame_mean_abs_u8": max(per_frame)}
    notes.update(frames_compared=len(per_frame), per_frame=per_frame,
                 reference_s=time.monotonic() - t0)
    return numbers, notes


def judge(numbers: Dict[str, float], limits: dict) -> Tuple[bool, dict]:
    """``(correct, {name: [value, limit]})``: each number at or under its
    limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = float(limits[name]["limit"])
        out[name] = [value, limit]
        ok = ok and value <= limit
    return ok, out
