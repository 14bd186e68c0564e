"""Per-frame serving latency on the card: mean, p50, p90, p99 and max.

Port of ``tools/latency_probe.py``.  A tier (the JAX tool's table:
``quality`` is ``QUALITY_CONFIG``, the others the tier files of
``TIER_CONFIGS``, seeded weights) serves ``--warmup`` and then
``--frames`` frames through ``Engine.process`` on the card, and two
distributions are taken over the same frames:

- device latency: CUDA events on the engine's stream around each
  frame's step and display (the replayed frame graph), no profiler;
- host-observed latency: a host clock around each ``Engine.process``
  (the call returns host bytes, so it holds the copies both ways).

Each prints mean / p50 / p90 / p99 / max, with whether p50 < 16.6 ms
(one frame at 60 fps).  The engine's K1 and K2 launches (warm-up steps
and capture, counted from 0) and the graph's recorded launches must
match the tier's res blocks and display, or the tool fails.

    python -m joshupscale_torch.tools.latency_probe [--tier quality] \\
        [--frames 200] [--warmup 8] [--height 270 --width 480] \\
        [--cpu --tiny]

``--cpu`` rehearses on the CPU: no device latency (there is no CUDA
event), the host clock's numbers labelled ``cpu``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from joshupscale_torch.tools.timing import tool_device, where

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

QUALITY_CONFIG = {
    # The flagship architecture (configs/inference_quality.yaml's).
    "flow": {"name": "flow-resnet", "num_inputs": 4,
             "num_filters": 64, "num_res_blocks": 10},
    "generator": {"name": "generator-resnet", "num_filters": 64,
                  "num_res_blocks": 24},
    "inference": {
        "name": "inference",
        "generator": {"model": "generator"},
        "flow": {"model": "flow"},
        "skip_processing": False,
        "frame_height": 270,
        "frame_width": 480,
        "compute_dtype": "bfloat16",
    },
}

TIER_CONFIGS = {
    "fast": "configs/inference_fast.yaml",
    "ps2": "configs/inference_ps2_style.yaml",
    "ps2_fast": "configs/inference_ps2_fast.yaml",
}
TARGET_MS = 16.6


def load_tier(tier: str) -> dict:
    """The models of ``tier``: a copy of ``QUALITY_CONFIG``, or its tier
    file's ``models:``."""
    if tier == "quality":
        return copy.deepcopy(QUALITY_CONFIG)
    from joshupscale_torch.export.package import load_model_config

    return load_model_config(os.path.join(REPO, TIER_CONFIGS[tier]))


def latency_stats(ms) -> dict:
    """Mean, p50, p90, p99 and max of ``ms`` (numpy's percentiles, linear
    interpolation)."""
    ms = np.asarray(ms, dtype=np.float64)
    return {"mean_ms": float(ms.mean()),
            "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max())}


def probe(engine, frames, warmup: int) -> dict:
    """``frames[:warmup]`` through ``engine.process`` untimed, then the
    rest timed: ``{"device": stats or None (the CPU), "process":
    stats}``.  On the card each frame's ``_serve`` (the graph's replay:
    step and display) is bracketed by CUDA events on the current
    stream; its input copy comes before the first event and its output
    copy after the second."""
    for f in frames[:warmup]:
        engine.process(f)
    cuda = engine.device.type == "cuda"
    pairs, host = [], []
    serve = engine._serve

    def timed_serve(frame):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = serve(frame)
        end.record()
        pairs.append((start, end))
        return out

    if cuda:
        engine._serve = timed_serve
    try:
        for f in frames[warmup:]:
            t0 = time.perf_counter()
            engine.process(f)
            host.append((time.perf_counter() - t0) * 1e3)
    finally:
        if cuda:
            del engine._serve
    device = None
    if cuda:
        torch.cuda.synchronize()
        device = latency_stats([s.elapsed_time(e) for s, e in pairs])
    return {"device": device, "process": latency_stats(host)}


def main(argv=None) -> int:
    from joshupscale_torch.kernels import launch_counts
    from joshupscale_torch.kernels.display import d2s_display_u8
    from joshupscale_torch.kernels.resblock import resblock_conv3x3
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import BUILD_STEPS, Engine
    from joshupscale_torch.tools.profile_step import (
        expected_launches,
        seeded_params,
        tiny_config,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", choices=["quality", "fast", "ps2", "ps2_fast"],
                    default="quality")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--height", type=int, default=None,
                    help="override LR frame height")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="32x48 frames, 1 res block a net")
    args = ap.parse_args(argv)

    device = tool_device(args.cpu, "latency_probe")
    label = where(device)
    config = load_tier(args.tier)
    if args.tiny:
        config = tiny_config(config)
    if args.height is not None:
        config["inference"]["frame_height"] = args.height
    if args.width is not None:
        config["inference"]["frame_width"] = args.width
    built = create_models(config, seed=args.seed)["inference"]
    model = built.obj
    for k in (resblock_conv3x3, d2s_display_u8):
        k.launches = 0
    engine = Engine(model, seeded_params(built, args.seed), device=device)
    h, w = model.frame_height, model.frame_width
    k1, k2 = expected_launches(config, model)
    if device.type == "cuda":
        counts = launch_counts()
        got = (counts["resblock_conv3x3"], counts["d2s_display_u8"],
               engine.graph_launches["resblock_conv3x3"],
               engine.graph_launches["d2s_display_u8"])
        want = (BUILD_STEPS * k1, BUILD_STEPS * k2, k1, k2)
        print(f"latency_probe: {args.tier} engine built: K1 / K2 launches "
              f"{got[0]} / {got[1]} (warm-up and captures), {got[2]} + "
              f"{got[3]} in the frame graph (the tier: {k1} + {k2})")
        if got != want:
            print(f"latency_probe: launches {got}, not {want}",
                  file=sys.stderr)
            return 1
    frames = np.random.default_rng(args.seed).integers(
        0, 256, (args.warmup + args.frames, h, w, 3), np.uint8)
    print(f"tier={args.tier} {w}x{h} -> {4 * w}x{4 * h}; "
          f"{args.warmup} warm-up + {args.frames} timed frames on {label}",
          flush=True)
    res = probe(engine, frames, args.warmup)
    for what, s in (("device (CUDA events, step + display)", res["device"]),
                    ("Engine.process (host clock, copies included)",
                     res["process"])):
        if s is None:
            print(f"  {what}: not measured ({label})")
            continue
        print(f"  {what}: mean {s['mean_ms']:.3f} ms  p50 "
              f"{s['p50_ms']:.3f}  p90 {s['p90_ms']:.3f}  p99 "
              f"{s['p99_ms']:.3f}  max {s['max_ms']:.3f}  "
              f"(p50 < {TARGET_MS} ms: {s['p50_ms'] < TARGET_MS}) on {label}")
    print(json.dumps({"tool": "latency_probe", "tier": args.tier,
                      "frames": args.frames, "on": label, **res,
                      "p50_meets_16.6ms": {
                          k: s["p50_ms"] < TARGET_MS
                          for k, s in res.items() if s is not None}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
