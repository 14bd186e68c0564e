"""The recurrence's drift over a 1000-frame clip.

Port of ``tools/drift_1000.py``.  A 1000-frame structured 480x270 clip
(a bouncing 2x-zoomed pan over ``--source``, noise added every 97th
frame) streams through the quality configuration (flow 64x10, generator
64x24, bf16, u8 frames in and out), and over the whole horizon it
measures:

1. the ``u8_state: true`` engine (the recurrent state rounded to u8
   every frame) against the float-state engine, chunk by chunk through
   ``process_clip``: per-frame mean / p99 / max u8 steps, at checkpoints
   and overall.  The recurrence compounds the rounding, so a bounded
   curve is what a few-frame test cannot show;
2. frame-by-frame ``process`` against ``process_clip`` at the
   checkpoints.  Both replay the same captured frame graph, so they
   agree to the bit.

Its last line is a JSON summary.  The sizes live in ``SIZES``; the
reference tool reads a fixed source path where this one takes
``--source`` (default ``docs/learned_compare.png``, which is too small
for an unreflected pan at 480x270: the help says how large).

    python -m joshupscale_torch.tools.drift_1000 --source IMG [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Tuple

import numpy as np

from joshupscale_torch.tools.make_synth_dataset import DEF_SOURCE


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The clip, its chunks, the checkpoints and the nets ((filters, res
    blocks) of the flow net and the generator)."""

    frames: int = 1000
    height: int = 270
    width: int = 480
    chunk: int = 50
    checkpoints: Tuple[int, ...] = (10, 100, 250, 500, 750, 999)
    flow: Tuple[int, int] = (64, 10)
    generator: Tuple[int, int] = (64, 24)
    compute_dtype: str = "bfloat16"


SIZES = Sizes()


def make_clip(src: np.ndarray, sizes: Sizes = None) -> np.ndarray:
    """(T, H, W, 3) u8: the bouncing pan over ``src``."""
    import cv2

    sizes = sizes or SIZES
    t_n, h, w = sizes.frames, sizes.height, sizes.width
    rng = np.random.default_rng(0)
    frames = np.empty((t_n, h, w, 3), np.uint8)
    cx, cy = 600.0, 400.0
    vx, vy = 1.3, 0.7
    for t in range(t_n):
        # Bounce the pan inside the source so the frames stay varied.
        cx += vx
        cy += vy
        if not 0 <= cx <= src.shape[1] - w * 2:
            vx = -vx
            cx += 2 * vx
        if not 0 <= cy <= src.shape[0] - h * 2:
            vy = -vy
            cy += 2 * vy
        m = np.array([[2.0, 0, cx], [0, 2.0, cy]], np.float32)
        frames[t] = cv2.warpAffine(
            src, m, (w, h), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            borderMode=cv2.BORDER_REFLECT)
        if t % 97 == 0:
            frames[t] = np.clip(frames[t].astype(np.int16)
                                + rng.integers(-8, 8, (h, w, 3)),
                                0, 255).astype(np.uint8)
    return frames


def build_engine(u8_state: bool, device, sizes: Sizes = None):
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import Engine

    sizes = sizes or SIZES
    config = {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": sizes.flow[0],
                 "num_res_blocks": sizes.flow[1]},
        "generator": {"name": "generator-resnet",
                      "num_filters": sizes.generator[0],
                      "num_res_blocks": sizes.generator[1]},
        "inference": {"name": "inference", "generator": {"model": "generator"},
                      "flow": {"model": "flow"}, "skip_processing": False,
                      "frame_height": sizes.height,
                      "frame_width": sizes.width,
                      "compute_dtype": sizes.compute_dtype,
                      "u8_state": u8_state},
    }
    built = create_models(config, seed=0)["inference"]
    return Engine(built.obj, built.params, device=device)


def diff_histograms(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """(T, 256) int64: frame t's histogram of |a[t] - b[t]| over its u8
    values, counted on ``device``."""
    import torch

    x, y = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for v in (a, b))
    # |a - b| in u8, and one 256-bin count a frame: few bins keep the
    # counts in fast memory, where one count over all frames' bins would
    # not.
    d = (torch.maximum(x, y) - torch.minimum(x, y)).reshape(len(a), -1)
    return torch.stack([torch.bincount(f, minlength=256)
                        for f in d]).cpu().numpy()


def hist_percentile(hist: np.ndarray, q: float) -> float:
    """``np.percentile`` (linear) of the values a histogram counts,
    computed as numpy computes it."""
    n = int(hist.sum())
    index = (n - 1) * (np.float64(q) / 100)
    lo = int(np.floor(index))
    gamma = index - lo
    cum = np.cumsum(hist)
    a = np.float64(np.searchsorted(cum, lo, side="right"))
    b = np.float64(np.searchsorted(cum, min(lo + 1, n - 1), side="right"))
    diff = b - a
    return float(a + diff * gamma if gamma < 0.5 else b - diff * (1 - gamma))


def frame_stats(hist: np.ndarray):
    """(mean, p99, max) of one frame's |diff| histogram."""
    values = np.arange(256)
    return (float((hist * values).sum() / hist.sum()),
            hist_percentile(hist, 99),
            int(values[hist > 0].max()))


def run(src: np.ndarray, device, sizes: Sizes = None,
        log: Callable[[str], None] = print) -> dict:
    """Both passes over the clip of ``src``; returns the summary."""
    sizes = sizes or SIZES
    clip = make_clip(src, sizes)
    log(f"clip: {clip.shape}")
    t_n, chunk, marks = sizes.frames, sizes.chunk, sizes.checkpoints
    eng_f = build_engine(False, device, sizes)
    eng_u8 = build_engine(True, device, sizes)

    # Pass 1: chunked clips through both engines, diffed frame by frame.
    t0 = time.time()
    stats, hist = [], np.zeros(256, np.int64)
    clip5 = clip[:, None]
    for start in range(0, t_n, chunk):
        part = clip5[start:start + chunk]
        hists = diff_histograms(eng_f.process_clip(part),
                                eng_u8.process_clip(part), device)
        hist += hists.sum(0)
        stats += [frame_stats(h) for h in hists]
        if start % 200 == 0:
            log(f"  frame {len(stats) - 1}: u8-vs-float mean "
                f"{stats[-1][0]:.3f} max {stats[-1][2]}")
    stats = np.asarray(stats)
    log(f"clip passes done in {time.time() - t0:.0f}s")
    del eng_u8

    # Pass 2: frame-by-frame process against process_clip.
    eng_f2 = build_engine(False, device, sizes)
    eng_f.reset()
    outs_ref, mismatch = {}, {}
    for start in range(0, t_n, chunk):
        out = eng_f.process_clip(clip5[start:start + chunk])
        for c in marks:
            if start <= c < start + chunk:
                outs_ref[c] = out[c - start, 0].copy()
    for t in range(t_n):
        out = eng_f2.process(clip[t])
        if t in marks:
            mismatch[t] = int(np.abs(out.astype(np.int16)
                                     - outs_ref[t].astype(np.int16)).max())
            log(f"  stream-vs-clip @{t}: max {mismatch[t]}")

    return {
        "frames": t_n,
        "u8_state_vs_float": {
            "mean_u8_steps_overall": float(stats[:, 0].mean()),
            # The pooled per-pixel p99, and the p99 of the frames' p99s.
            "p99_u8_steps_overall": int(np.searchsorted(
                np.cumsum(hist), 0.99 * hist.sum())),
            "p99_of_frame_p99s": float(np.percentile(stats[:, 1], 99)),
            "max_u8_steps_overall": int(stats[:, 2].max()),
            "mean_by_checkpoint": {str(c): float(stats[c, 0])
                                   for c in marks},
            "max_by_checkpoint": {str(c): int(stats[c, 2]) for c in marks},
        },
        "stream_vs_clip_max_u8": mismatch,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=DEF_SOURCE,
                    help="the image the clip pans over (at least "
                         f"{2 * SIZES.width + 600}x{2 * SIZES.height + 400} "
                         "for an unreflected pan)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    import cv2

    from joshupscale_torch import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    src = cv2.imread(args.source, cv2.IMREAD_COLOR)
    if src is None:
        raise SystemExit(f"cannot read source image {args.source}")
    print(json.dumps(run(src, device, log=lambda m: print(m, flush=True))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
