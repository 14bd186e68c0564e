"""Per-op device profile of a serving step on the card.

Port of ``tools/profile_step.py``.  The quality tier's step (or any
tier's YAML with ``--config``) at 270x480 bf16, seeded weights
(``seeded_params``), is built as ``Engine`` serves it: one captured CUDA
graph a frame.  A window of ``--frames`` replays is traced under
``torch.profiler``, warmed up inside the session (one replay, then an
idle gap; only the records after the gap count: ``replay_kernels``), and
the device's kernels, copies and fills are summed by name and by part
(``kernel_group``) a frame, with the device's busy time (overlapping
records counted once, ``timing.busy_parts``) and idle share over the
window.  Every replay must launch the K1 and K2 the graph recorded (68 +
1 on the quality tier), or the tool fails.

    python -m joshupscale_torch.tools.profile_step [--frames 32] \\
        [--top 30] [--height 270] [--width 480] \\
        [--config configs/inference_ps2_style.yaml] [--cpu --tiny]

``--cpu`` rehearses it on the CPU (no graph, no device: the step's CPU
ops are profiled instead, every number labelled ``cpu``); ``--tiny``
serves 32x48 frames on nets cut to 1 res block.  ``chip_smoke.py`` uses
this module's ``profiled``, ``kernel_group``, ``replay_kernels``,
``counted_session``, ``log_parts`` and ``seeded_params``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from joshupscale_torch.runtime.spans import unmarked
from joshupscale_torch.tools.latency_probe import QUALITY_CONFIG
from joshupscale_torch.tools.timing import busy_parts, tool_device, where

# After each torch.profiler session Kineto detaches CUPTI and attaches
# it again, lazily, at the next one.  PyTorch turns both off when it
# profiles CUDA graphs of its own (torch/profiler/profiler.py): replayed
# graphs are not traced reliably across a re-attach.  ``profiled`` sets
# them before its session (``chip_smoke.py`` before importing torch).
CUPTI_ENV = {"DISABLE_CUPTI_LAZY_REINIT": "1", "TEARDOWN_CUPTI": "0"}
PROFILE_SESSIONS = 3  # a profiled window's sessions, while none is traced
# The card's idle time between a session's first replay and the counted
# ones (``replay_kernels``): far longer than any gap inside a replay.
REPLAY_GAP_S = 0.05
K1, K2 = "K1 resblock_conv3x3", "K2 d2s_display_u8"
K3 = "warp s2d (fused)"

TINY = (32, 48)  # --tiny: LR frame size; the nets keep 1 res block


def kernel_group(name: str) -> str:
    """The part of a step a CUDA kernel belongs to, by its name."""
    low = name.lower()
    if name.startswith("triton_"):
        # inductor's fused kernels are named after the ops they fuse,
        # "resblock_conv3x3" and "d2s_display_u8" among them
        return "inductor (fused Triton)"
    if "conv3x3" in name:
        return K1
    if "warp_s2d" in name:
        return K3
    if "i16832gemm" in name or "imma" in low:
        return "int8 product (_int_mm)"
    if "reduce_kernel" in name:
        return "reductions (absmax, BN statistics)"
    if "indexfunc" in low or "index_add" in low:
        return "index_add (s2d warp backward)"
    if "multi_tensor_apply" in low:
        return "foreach (Adam, BN merge)"
    if "d2s_display" in name:
        return K2
    if "max_pool" in low:
        return "max pool"
    if "index_elementwise" in name:
        return "warp row gather (index)"
    if "conv" in low or "xmma" in low or "cudnn" in low:
        return "library convs"
    if "gemm" in low:
        return "gemm (tail products)"
    if "CatArray" in name or "cat_" in low:
        return "cat (tables, inputs, stacks)"
    return "other elementwise"


def profiled(fn: Callable[[], object], trace_path=None, cpu=False):
    """``fn()`` under a ``torch.profiler`` session (CPU and CUDA
    activities), the card synchronized before and after: the profile and
    its device kernels, copies and fills (``{"name", "ts", "dur"}``, µs,
    read from the profiler's results; the Chrome trace is written only
    to ``trace_path``, if given).  A session that holds no device event
    is logged and run again, ``fn`` with it, up to ``PROFILE_SESSIONS``
    sessions.  ``cpu``: a rehearsal on the CPU, whose ``aten::`` op
    records stand in for the device's."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    os.environ.update(CUPTI_ENV)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    kind = torch.autograd.DeviceType.CPU if cpu else \
        torch.autograd.DeviceType.CUDA
    activities = [ProfilerActivity.CPU] + (
        [] if cpu else [ProfilerActivity.CUDA])
    for session in range(1, PROFILE_SESSIONS + 1):
        sync()
        with tprofile(activities=activities) as prof:
            fn()
            sync()
        if trace_path:
            prof.export_chrome_trace(trace_path)
        results = prof.profiler.kineto_results.events()
        events = [{"name": e.name(), "ts": e.start_ns() / 1e3,
                   "dur": e.duration_ns() / 1e3}
                  for e in results if e.device_type() == kind
                  and (not cpu or e.name().startswith("aten::"))]
        if events:
            return prof, events
        runtime = [e.name() for e in results if e.name().startswith("cuda")]
        print(f"profiler session {session} of {PROFILE_SESSIONS} recorded "
              f"no device activity ({len(results)} events; {len(runtime)} "
              f"CUDA runtime calls, {runtime.count('cudaGraphLaunch')} of "
              f"them cudaGraphLaunch)", flush=True)
    raise RuntimeError(f"the profiler recorded no device activity in "
                       f"{PROFILE_SESSIONS} sessions")


def after_gap(events, gap_s=REPLAY_GAP_S / 2):
    """The device events after the largest idle gap of the card's
    timeline, if that gap is longer than ``gap_s``; else all of them."""
    events = sorted(events, key=lambda e: e["ts"])
    gaps = [(b["ts"] - (a["ts"] + a["dur"]), i + 1)
            for i, (a, b) in enumerate(zip(events, events[1:]))]
    gap, start = max(gaps, default=(0.0, 0))
    return events[start:] if gap > gap_s * 1e6 else events


def warm_session(run: Callable[[], object], n: int, cpu=False):
    """A session's calls: ``run()`` once, the card idle ``REPLAY_GAP_S``,
    then ``n`` calls, whose records are the ones after the gap
    (``after_gap``): on an H100 with torch 2.11 a session's first call
    could lose the records of its first kernels (a replayed graph's
    first 20 K1 in every one of 3 sessions; an artifact's flow net, 12
    of 36 K1), where the calls after it kept all of theirs."""
    def calls():
        run()
        if not cpu:
            torch.cuda.synchronize()
        time.sleep(REPLAY_GAP_S)
        for _ in range(n):
            run()
    return calls


def replay_kernels(engine, dev_frame, n=3, trace_path=None):
    """The device events of ``n`` replayed steps under ``torch.profiler``
    (the CUDA graph's kernels, traced one by one; the trace is written
    to ``trace_path`` if given), warmed up inside the session
    (``warm_session``), and K1's and K2's kernels per replay.  The
    replays run the graph that the engine serves, not its marked one
    (``runtime.spans.unmarked``)."""
    cpu = engine.device.type == "cpu"
    for _ in range(2):
        engine.step(dev_frame)
    with unmarked():
        prof, events = profiled(
            warm_session(lambda: engine.step(dev_frame), n, cpu),
            trace_path, cpu)
    events = after_gap(events)
    groups = [kernel_group(e["name"]) for e in events]
    per = (groups.count(K1) / n, groups.count(K2) / n)
    return prof, events, per


def counted_session(name, count, expected, log=print):
    """``count()`` (a profiler session's kernel counts) and the sessions
    it took to equal ``expected``, over up to ``PROFILE_SESSIONS``
    sessions.  A session that counts fewer is logged and run again: a
    replayed graph or a loaded artifact launches the same kernels at
    every call, and a session can lose kernel records (on an H100 with
    torch 2.11, one session read 62 of an artifact's 68 K1, and one 65 of
    the quality graph's, where the sessions before and after read 68).
    A session that counts more fails at once."""
    for session in range(1, PROFILE_SESSIONS + 1):
        got = count()
        if got == expected:
            return got, session
        log(f"{name}: profiler session {session} of {PROFILE_SESSIONS} "
            f"counted {got} K1/K2 kernels, not {expected}")
        if any(g > e for g, e in zip(got, expected)):
            break
    return got, session


def step_parts(events, n):
    """Device ms a frame by part (busy time, ``busy_parts``) of ``n``
    frames' records."""
    return {k: v / n for k, v in busy_parts(events, kernel_group).items()}


def log_parts(name, engine, dev_frame, log=print):
    """The device time of ``engine``'s replayed step by kernel group,
    from a profile of 3 replays (busy time: overlapping records count
    once)."""
    _, events, _ = replay_kernels(engine, dev_frame)
    groups = step_parts(events, 3)
    log(f"{name}: {len(events) / 3:.0f} device ops a replayed step, "
        f"{sum(groups.values()):.3f} ms of device time: " + "; ".join(
            f"{k} {v:.3f}" for k, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])))
    return groups


def seeded_params(built, seed: int):
    """Random weights with BN stats perturbed, scaled so activations stay
    O(1) through 24 res blocks and the output is not clipped flat: each
    res block's residual branch (bn_2 gamma) and the two heads are
    damped.  The autoencoder's double convs are left as they are."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=""):
        for k, v in tree.items():
            p = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            elif k == "moving_mean":
                v.copy_(torch.from_numpy(
                    rng.standard_normal(v.shape).astype(np.float32) * 0.1))
            elif k == "moving_variance":
                v.copy_(torch.from_numpy(
                    1 + rng.random(v.shape).astype(np.float32)))
            elif (k == "gamma" and ".block_" in f".{p}" and "bn_2" in p
                  and (p.startswith("generator") or resnet_flow)):
                v.mul_(0.2)
    params = built.params
    # The resnet flow net has res blocks and a 1x1 head (OHWI kernel).
    resnet_flow = ("flow" in params
                   and params["flow"]["conv_2"]["kernel"].shape[1] == 1)
    walk(params)
    if "flow" in params:
        params["flow"]["conv_2"]["kernel"].mul_(0.5)
    params["generator"]["conv_trans_2"]["kernel"].mul_(0.5)
    return params


def cut_blocks(config: dict, blocks: int) -> dict:
    """``config`` with its resnets cut to at most ``blocks`` res blocks
    (an autoencoder flow net has none and stays)."""
    config = copy.deepcopy(config)
    for entry in config.values():
        if "num_res_blocks" in entry:
            entry["num_res_blocks"] = min(entry["num_res_blocks"], blocks)
    return config


def tiny_config(config: dict) -> dict:
    """``--tiny``: ``config`` at 32x48 frames, its resnets cut to 1 res
    block."""
    config = cut_blocks(config, 1)
    config["inference"] = dict(config["inference"], frame_height=TINY[0],
                               frame_width=TINY[1])
    return config


def expected_launches(config: dict, model) -> tuple:
    """K1 and K2 launches a frame of ``config``'s inference entry: two K1
    a res block of each resnet, one K2 where the display is deferred."""
    from joshupscale_torch.runtime.engine import _deferred

    entry = config["inference"]
    nets = [entry[k]["model"] for k in ("flow", "generator") if k in entry]
    k1 = sum(2 * config[n].get("num_res_blocks", 0) for n in nets
             if config[n]["name"].endswith("resnet"))
    return k1, int(_deferred(model))


def build_step(height=270, width=480, dtype="bfloat16", config_path=None,
               device=None, params=None, seed=0, blocks=None):
    """The serving step of the quality architecture (or of the tier YAML
    ``config_path``, its dtype kept) at ``height`` x ``width``, as
    ``Engine`` serves it on ``device``: ``(engine, config)``.  Weights:
    ``params`` (a nested tree), else ``seeded_params`` of the registry's
    init at ``seed``; ``blocks`` cuts the resnets' depth."""
    from joshupscale_torch.export.package import load_model_config
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import Engine

    if config_path:
        config = load_model_config(config_path)
        config["inference"] = dict(config["inference"], frame_height=height,
                                   frame_width=width)
    else:
        config = copy.deepcopy(QUALITY_CONFIG)
        config["inference"].update(frame_height=height, frame_width=width,
                                   compute_dtype=dtype)
    if blocks:
        config = cut_blocks(config, blocks)
    built = create_models(config, seed=seed)["inference"]
    if params is None:
        params = seeded_params(built, seed)
    return Engine(built.obj, params, device=device), config


def frame_profile(events, n, top=30):
    """A traced window of ``n`` frames: each name's and each part's
    device ms a frame (parts by busy time), the busy ms a frame, the
    window (first record's start to last record's end) a frame and the
    idle share, the ops a frame, and the ``top`` names."""
    by_name: Dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3 / n
    parts = step_parts(events, n)
    busy = sum(parts.values())
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3 / n
    return {"ops": len(events) / n, "busy_ms": busy, "window_ms": span,
            "idle_share": 1 - busy / span if span else 0.0, "parts": parts,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32,
                    help="replays in the traced window")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--config", default=None,
                    help="serving-tier YAML (default: quality arch)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="write the window's Chrome trace here")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (numbers say cpu)")
    ap.add_argument("--tiny", action="store_true",
                    help="32x48 frames, 1 res block a net")
    args = ap.parse_args(argv)

    device = tool_device(args.cpu, "profile_step")
    label = where(device)
    h, w = TINY if args.tiny else (args.height, args.width)
    engine, config = build_step(h, w, args.dtype, args.config, device,
                                seed=args.seed,
                                blocks=1 if args.tiny else None)
    expected = expected_launches(config, engine.model)
    rng = np.random.default_rng(args.seed)
    frames = rng.integers(0, 256, (2, h, w, 3), np.uint8)
    for f in frames:
        engine.process(f)
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    cpu = device.type == "cpu"
    if not cpu:
        recorded = (engine.graph_launches["resblock_conv3x3"],
                    engine.graph_launches["d2s_display_u8"])
        if recorded != expected:
            print(f"profile_step: the graph recorded {recorded} K1/K2, the "
                  f"config makes {expected}", file=sys.stderr)
            return 1
    last = {}

    def count():
        _, last["events"], per = replay_kernels(engine, dev_frame,
                                                args.frames, args.trace)
        return per

    per, sessions = counted_session("profile_step", count,
                                    (0.0, 0.0) if cpu else expected)
    prof = frame_profile(last["events"], args.frames, args.top)
    unit = "cpu ms" if cpu else "ms"
    print(f"profile_step: {w}x{h} -> {4 * w}x{4 * h}, "
          f"{args.config or 'quality'}, {args.frames} replayed frames in "
          f"one profiler session ({sessions} session(s)); {per[0]:g} K1 + "
          f"{per[1]:g} K2 a frame (the graph recorded {expected[0]} + "
          f"{expected[1]}) on {label}")
    print(f"  {prof['ops']:.0f} ops a frame; busy {prof['busy_ms']:.3f} "
          f"{unit} a frame of a {prof['window_ms']:.3f} {unit} window, idle "
          f"share {prof['idle_share']:.3f} on {label}")
    for k, v in sorted(prof["parts"].items(), key=lambda kv: -kv[1]):
        print(f"  {v:9.4f} {unit}/frame  {k}")
    print(f"\n{'us/frame':>10}  {'%':>5}  op")
    for name, ms in prof["top"]:
        print(f"{ms * 1e3:>10.1f}  {100 * ms / prof['busy_ms']:>5.1f}  "
              f"{name[:110]}")
    print(json.dumps({"tool": "profile_step", "on": label,
                      "k1_per_frame": per[0], "k2_per_frame": per[1],
                      "busy_ms": prof["busy_ms"],
                      "idle_share": prof["idle_share"],
                      "parts": prof["parts"]}))
    if per != (expected if not cpu else (0.0, 0.0)):
        print(f"profile_step: a replay ran {per} K1/K2 kernels, not "
              f"{expected}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
