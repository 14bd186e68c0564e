"""The one traffic generator: input frames from a mix's parameters and a
seed.

A mix (``benchmark/traffic/<mix>.json``) gives the streams served side by
side, the entry that serves them, the shot length, the ring of frames,
the pan and the texture.  Each stream is a seeded texture panned by
``pan_lr_px_per_frame`` (y, x) LR pixels a frame: a sum of ``waves``
plane waves of random direction, period (log-uniform between
``min_period_px`` and ``max_period_px``), phase and colour, pushed through
``tanh`` with ``contrast`` for hard edges, in u8 BGR.  Each wave's
temporal rate is rounded to a whole number of cycles over the ring, so
the ring of ``ring_frames`` frames loops without a seam; frame ``i`` of a
run is ``ring[i % ring_frames]``.  The seed changes the textures only:
sizes, pan, shots and the number of frames are the mix's, the same for
every seed.  The frames are computed on the run's device in chunks and
handed over as one contiguous host array (``ring_frames``, streams, H,
W, 3), made during set-up so that the host does not pace the loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchlib.weights import generator

_CHUNK_PIXELS = 1 << 20  # pixels a chunk of frames (x waves x 4 bytes)


def _waves(tex: dict, pan, ring: int, g: torch.Generator, device):
    """Per wave: wave vector (2,) in cycles/px, temporal cycles over the
    ring (an integer), phase, colour (3,), amplitude."""
    j = int(tex["waves"])
    u = torch.rand((j, 7), generator=g, device=device, dtype=torch.float64)
    lo, hi = math.log(tex["min_period_px"]), math.log(tex["max_period_px"])
    period = torch.exp(lo + (hi - lo) * u[:, 0])
    theta = 2 * math.pi * u[:, 1]
    k = torch.stack([torch.sin(theta), torch.cos(theta)], 1) / period[:, None]
    v = torch.tensor(pan, dtype=torch.float64, device=device)
    vv = float((v * v).sum())
    cycles = torch.round((k @ v) * ring)
    if vv > 0:  # move k along v so that k . v = cycles / ring exactly
        k = k + ((cycles / ring - k @ v) / vv)[:, None] * v[None]
    phase = 2 * math.pi * u[:, 2]
    colour = u[:, 3:6] * 2 - 1
    amp = torch.sqrt(period / tex["max_period_px"])
    return k, cycles, phase, colour, amp


def make_ring(mix: dict, seed: int, height: int, width: int,
              device) -> np.ndarray:
    """(ring_frames, streams, H, W, 3) u8 frames of ``mix`` from ``seed``."""
    ring, streams = int(mix["ring_frames"]), int(mix["streams"])
    pan = mix["pan_lr_px_per_frame"]
    tex = mix["texture"]
    g = generator(seed * 2 + 1, device)  # another stream than the weights'
    out = np.empty((ring, streams, height, width, 3), np.uint8)
    yy, xx = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float64),
        torch.arange(width, device=device, dtype=torch.float64),
        indexing="ij")
    pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], 1)  # (HW, 2)
    step = max(1, _CHUNK_PIXELS // (height * width))
    for s in range(streams):
        k, cycles, phase, colour, amp = _waves(tex, pan, ring, g, device)
        norm = float(torch.sqrt((amp * amp).sum() / 2))
        spatial = (pos @ k.T).float()  # (HW, J) cycles
        weights = (colour * amp[:, None] / norm).float()  # (J, 3)
        for t0 in range(0, ring, step):
            t = torch.arange(t0, min(ring, t0 + step), device=device,
                             dtype=torch.float64)
            shift = (t[:, None] * cycles[None] / ring).float()  # (T, J)
            arg = spatial[None] - shift[:, None] + (
                phase / (2 * math.pi)).float()
            wave = torch.sin(2 * math.pi * torch.remainder(arg, 1.0))
            val = torch.tanh(tex["contrast"] * (wave @ weights))
            u8 = torch.clamp(torch.round(127.5 + 127.5 * val), 0, 255)
            out[t0:t0 + len(t), s] = u8.to(torch.uint8).reshape(
                len(t), height, width, 3).cpu().numpy()
    return out
