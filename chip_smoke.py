#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Builds the port's CUDA kernels from ``joshupscale_torch/csrc`` and
prints each kernel's registers and spills (``ptxas -v``), holds K1 (C =
32, 48, 64; full frame at 48 and 64, and at N = 2 and 4) and K2 (full
frame at N = 1, 2 and 4) against their plain PyTorch versions on the
card, then drives every serving path through
``Engine.process`` with seeded random weights at 270x480 -> 1080x1920:
the quality tier (flow-resnet 64x10 + generator-resnet 64x24, bf16,
68 K1 + 1 K2 launches a step), the PS2 tiers (flow autoencoder,
272x480 padding, brightness; generator 64x24: 48 K1 + 1 K2, generator
48x12: 24 K1 + 1 K2) and the serving options on the PS2-fast
architecture (u8 state, moving average global and windowed,
output_flow: 0 K1, remove_flow and pixel mode: no K2).  On the card a
frame is one replayed CUDA graph (``runtime/engine.py``), so for each
path it sets the launch counts to 0, builds the engine (warm-up steps
and the capture) and serves frames: the counts hold the warm-up and
captured steps' launches and nothing from the replays, and the graph's
recorded launches are checked per step.  It checks that the output is
not clipped flat, that a replayed step makes no synchronising call,
that replays equal eager steps bit for bit across a ``reset()``, and
holds frames against the same engine run on the CPU (plain versions).
It times the frame, the step eager against replayed, and each kernel
with CUDA events.  On the quality tier it drives the runtime:
``process_async`` and ``process_clip`` against ``process``, a
``VideoStream`` on the card against the CPU, ``NativeEngine`` on a
package written by ``save_package``, then splits ``process`` into its
parts and times ``process_async`` and ``Engine.benchmark``.  The int8
tier (``quantize_params_int8``: 0 K1 + 1 K2 a frame) is driven and
checked like the float paths on the quality tier with dynamic scales,
with scales from ``calibrate`` (run on the card and on the CPU, the
range maps compared) and on ``ps2_style``, timed, and held against the
float tier's frames (mean u8 difference and PSNR, informational).
Multi-stream serving: ``ShardedEngine`` on the card with 2 and 4 streams
(K1 at N = 2 and 4; checked against ``Engine(batch_size=2)`` and each
stream against the single-stream engine, frames/s beside it), ``PipelinedEngine`` with both stages
on the card (two frame graphs; checked against ``Engine``, latency and
``process_async`` throughput beside it).  ``SpatialEngine`` (one
stream's frame split by rows, K1 on slab plus halo, K2 per slab;
``phase_spatial``) on the quality tier with 2 and 4 slabs and on
``ps2_style`` with 2, every slab on the card: 6 frames and one after
``reset()`` held against ``Engine.process`` bit for bit (else the first
layer that differs is printed and the frames must stay within u8 max
1), K1 and K2 launches a frame checked (136 + 2 on quality with 2
slabs), ``process`` timed beside ``Engine.process``.  K1 is timed at
N = 2.  FRVSR training follows (``phase_train``): the models of
``configs/frvsr_quality.yaml`` at full width (flow 64x10, generator
64x24; batch 4, T = 10, LR crop 32) built by the training CLI's
builder, ``fit`` for 2 epochs x 3 steps with validation and
checkpoints, one float32 step held against the CPU (loss and every
gradient), steps timed in float32 and bf16 (forward, backward,
optimizer; peak memory), no kernel launched by a train step; then the
trained params exported as a serving package (270x480, bf16) and served
through ``create_runtime`` + ``Engine.process`` with the counts set to 0
(68 K1 + 1 K2 a step), checked as the serving paths are.  The doors
phase (``phase_doors``) follows the GAN phase: pair examples at the
capture size (10 LR 270x480 + 10 HR 1080x1920 PNG frames each) written
with the port's TFRecord writer; the FRVSR train chain on them through
``MultiprocessLoader`` with 2 workers (held bit for bit against the
in-process shards; batches/s; no ``/dev/shm`` segment left); the
training CLI with ``data_workers`` 2 and 0 at full width (step times);
its export (package, ``model.onnx``, ``model_fp16.onnx``) served
through ``create_runtime`` (68 K1 + 1 K2 a step); ``load_trained_params``
on the fit's checkpoint served bit for bit with the package; and the
ONNX graphs run on the card (``run_graph_torch``) against the float32
``Engine``: f32 within u8 max 1, fp16 and an int8 QDQ graph (ranges
from ``calibrate`` on the card) within the card-vs-CPU bound.  The mesh
phase (``phase_mesh``) follows: the data-parallel step
(``parallel.mesh``) of the full-width FRVSR (float32, global batch 4)
on 2 gloo ranks sharing the card, 2 steps against the same steps in
this process (``tools.mesh_parity``: loss and gradients within the
card-vs-CPU step's bounds, the ranks' params bit for bit), one damped
GAN step the same way (the same gate decision), the ranks' all-reduce
count and gloo's all-reduce time, and rank 0's params served as a
package (68 K1 + 1 K2 a step, frames against the one-process params'
package).  Then it
drives the conv probe (``joshupscale_torch.tools.conv_probe.run``),
which holds P1 and P2 against their plain versions at full shape (all
five variants) and times them; checks that it went through P1 and P2;
and prints K1, P2, P1 and cuDNN side by side at the res-block conv's
shape, and P2's fused pair (a whole res block in one launch) beside
K1's two launches.  Last come the phases under ``torch.profiler``
(a profiler session can leave the host launching more slowly, so every
host-clock timing comes before them; the quality step is timed once
more after them, labelled): each path's replays counted by kernel, the
PS2 steps' device time split by stage and kernel, and ``fit``'s profiler
window (``profile_fit``: 4 full-width bf16 FRVSR steps, steps 1..2
traced; the trace must hold CUDA kernel events).  K1's and the
probes' lines and kernel entries carry the
share of the bf16 peak and the fraction of the bound's rate.  Fails if
P2 spills registers.

Prints one line per phase, then the card's name and power limit, a JSON
line with the kernel table, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, on any failure -- including when there is no CUDA device.
``--profile DIR`` also writes a torch.profiler summary of each tier's
replayed frames there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM data-sheet peaks (dense): the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

H, W = 270, 480
K1_PER_FRAME = 2 * (10 + 24)
FRAMES = 8  # driven through Engine.process, launches counted
REF_FRAMES = 3  # of those, held against the CPU run
TIMED_FRAMES = 53  # Engine.process latency; the first 3 are dropped
VARIANT_FRAMES = 3  # each serving option: driven, counted, held vs CPU
INT8_REF_FRAMES = 2  # each int8 path: held against the CPU run
REPLAY_FRAMES = 6  # each path: replays held against eager steps
PROFILE_SESSIONS = 3  # a profiled window's sessions, while none is traced
# After each torch.profiler session Kineto detaches CUPTI and attaches
# it again, lazily, at the next one.  PyTorch turns both off when it
# profiles CUDA graphs of its own (torch/profiler/profiler.py): replayed
# graphs are not traced reliably across a re-attach.  Every frame here
# is a replayed graph, so main() does the same before importing torch.
CUPTI_ENV = {"DISABLE_CUPTI_LAZY_REINIT": "1", "TEARDOWN_CUPTI": "0"}


def log(msg: str) -> None:
    print(msg, flush=True)


def k1_flops(n, h, w, c) -> float:
    return 2.0 * n * h * w * 9 * c * c


def k1_bound_ms(n, h, w, c, residual) -> tuple:
    """K1's bound in bf16: each input read once, the output written once,
    against the matmul work at the tensor cores' bf16 peak."""
    itemsize = 2
    act = n * h * w * c * itemsize
    nbytes = act * (3 if residual else 2) + 9 * c * c * itemsize + 2 * c * 4
    flops = k1_flops(n, h, w, c)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k1(torch, rng, device):
    """K1 vs its plain version: the full frame in bf16 at C = 64 (the
    quality and PS2-style generators), 48 (PS2-fast) and C = 64 at N = 2
    and 4 (the batches of ``ShardedEngine``), C = 32/48 and f32 small.
    Returns the largest error at full frame by C (N = 2 and 4 as "n2"
    and "n4")."""
    from joshupscale_torch.kernels.resblock import (
        resblock_conv3x3, resblock_conv3x3_plain)

    def operands(shape, c, dtype):
        n, h, w = shape
        mk = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32))
        x = (mk(n, h, w, c) * 0.5).to(device, dtype)
        wt = (mk(c, 3, 3, c) / np.sqrt(9 * c)).to(device, dtype)
        scale = (0.5 + torch.from_numpy(rng.random(c).astype(np.float32))
                 ).to(device)
        offset = (mk(c) * 0.1).to(device)
        res = mk(n, h, w, c).to(device, dtype)
        return x, wt, scale, offset, res

    # Both sides take the same bf16/f32 inputs, sum in f32 (no TF32) and
    # round once: they may differ by the f32 summation order and one
    # rounding of the output, i.e. about one bf16 ulp (2^-8 relative).
    tol = {torch.bfloat16: 1 / 64, torch.float32: 1e-4}
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [((1, H, W), 64, bf16), ((1, H, W), 48, bf16),
             ((2, H, W), 64, bf16), ((4, H, W), 64, bf16),
             ((2, 19, 37), 32, bf16),
             ((2, 19, 37), 48, bf16), ((1, 45, 80), 64, f32),
             ((2, 19, 37), 32, f32)]
    worst_main = {64: 0.0, 48: 0.0, "n2": 0.0, "n4": 0.0}
    for shape, c, dtype in cases:
        x, wt, s, t, r = operands(shape, c, dtype)
        for res, act in ((None, "relu"), (r, "relu"), (r, "lrelu")):
            before = resblock_conv3x3.launches
            got = resblock_conv3x3(x, wt, s, t, res, act, 0.3)
            torch.cuda.synchronize()
            if resblock_conv3x3.launches != before + 1:
                raise AssertionError("K1 launch counter did not move")
            ref = resblock_conv3x3_plain(x, wt, s, t, res, act, 0.3)
            err = (got.float() - ref.float()).abs()
            bound = tol[dtype] * (1 + ref.float().abs())
            worst = float(err.max())
            if not bool((err <= bound).all()) or not torch.isfinite(got).all():
                raise AssertionError(
                    f"K1 {shape} C={c} {dtype} res={res is not None} {act}: "
                    f"max abs err {worst}")
            if shape[1:] == (H, W):
                key = c if shape[0] == 1 else f"n{shape[0]}"
                worst_main[key] = max(worst_main[key], worst)
            log(f"K1 {dtype} {shape} C={c} residual={res is not None} "
                f"{act}: max_abs_err={worst:.3g} (bound {tol[dtype]:.3g}"
                f"*(1+|ref|)) ok")
    return worst_main


def phase_k2(torch, rng, device):
    """K2 vs its plain version, bit-exact, at N = 1, 2 (as T x N) and 4
    (``ShardedEngine``'s batches); returns the largest |got - ref| over
    the cases (0 when they agree)."""
    from joshupscale_torch.kernels.display import (
        d2s_display_u8, d2s_display_u8_plain)

    worst = 0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, H, W, 48), (2, 1, H, W, 48), (4, H, W, 48)):
            x = torch.from_numpy(np.clip(
                rng.standard_normal(shape).astype(np.float32) * 0.3,
                -0.5, 0.5)).to(device, dtype)
            before = d2s_display_u8.launches
            got = d2s_display_u8(x)
            torch.cuda.synchronize()
            if d2s_display_u8.launches != before + 1:
                raise AssertionError("K2 launch counter did not move")
            ref = d2s_display_u8_plain(
                x.reshape((-1,) + tuple(x.shape[-3:]))).reshape(got.shape)
            worst = max(worst, int((got.int() - ref.int()).abs().max()))
            if not torch.equal(got, ref):
                n_bad = int((got != ref).sum())
                raise AssertionError(f"K2 {dtype} {shape}: {n_bad} values "
                                     f"differ from the plain version")
            log(f"K2 {dtype} {shape} -> {tuple(got.shape)} u8: bit-exact ok")
    return float(worst)


def serving_config(flow: dict, gen_filters: int, gen_blocks: int,
                   **inference) -> dict:
    """A serving config at full frame in bf16 (the tiers' own, as in
    ``configs/inference_*.yaml``)."""
    config = {
        "flow": flow,
        "generator": {"name": "generator-resnet", "num_filters": gen_filters,
                      "num_res_blocks": gen_blocks},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": "bfloat16",
                      **inference},
    }
    if inference.get("remove_flow"):
        del config["flow"], config["inference"]["flow"]
    return config


def quality_config() -> dict:
    return serving_config({"name": "flow-resnet", "num_inputs": 4,
                           "num_filters": 64, "num_res_blocks": 10}, 64, 24)


PS2_LADDERS = {"ps2_style": ([32, 64, 128, 256, 128, 64, 32], 64, 24),
               "ps2_fast": ([16, 32, 64, 128, 64, 32, 16], 48, 12)}


def ps2_config(tier: str, **options) -> dict:
    filters, gen_filters, gen_blocks = PS2_LADDERS[tier]
    return serving_config(
        {"name": "flow-autoencoder", "num_inputs": 4, "filters": filters},
        gen_filters, gen_blocks, flow_pad_factor=8,
        normalize_brightness=True, **options)


# The serving options, on the PS2-fast architecture: (options, K1 and K2
# launches a frame).  output_flow runs no generator; remove_flow and
# pixel mode make the u8 frame in the step (no deferred display).
_FAST_K1 = 2 * PS2_LADDERS["ps2_fast"][2]
VARIANTS = {
    "u8_state": ({"u8_state": True}, _FAST_K1, 1),
    "moving_avg_window0": (
        {"frame_moving_avg": {"strength": 0.7, "threshold": 0.1}},
        _FAST_K1, 1),
    "moving_avg_window16": (
        {"frame_moving_avg": {"strength": 0.7, "threshold": 0.1,
                              "window": 16}}, _FAST_K1, 1),
    "output_flow": ({"output_flow": True}, 0, 1),
    "remove_flow": ({"remove_flow": True}, _FAST_K1, 0),
    "pixel_mode": ({"s2d_mode": False}, _FAST_K1, 0),
}


def seeded_params(torch, built, seed: int):
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


def frames_for(t: int, seed: int) -> np.ndarray:
    """Smooth moving patterns plus noise, (t, H, W, 3) u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for i in range(t):
        base = [np.sin(xx * 0.045 + i * 0.4 + ch) * np.cos(yy * 0.06 - i * 0.2)
                for ch in range(3)]
        img = 127.5 + 90 * np.stack(base, -1)
        img += rng.standard_normal(img.shape) * 8
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def all_kernels():
    """The four kernels' wrappers: K1, K2, P1, P2."""
    from joshupscale_torch.kernels.display import d2s_display_u8
    from joshupscale_torch.kernels.probes import probe_dot, probe_patch_dot
    from joshupscale_torch.kernels.resblock import resblock_conv3x3
    return resblock_conv3x3, d2s_display_u8, probe_dot, probe_patch_dot


def replay_kernels(torch, engine, dev_frame, n=3, trace_path=None):
    """The device events of ``n`` replayed steps under ``torch.profiler``
    (the CUDA graph's kernels, traced one by one; the trace is written
    to ``trace_path`` if given) and K1's and K2's kernels per replay."""

    def replays():
        for _ in range(n):
            engine.step(dev_frame)

    for _ in range(2):
        engine.step(dev_frame)
    prof, events = profiled(torch, replays, trace_path)
    groups = [kernel_group(e["name"]) for e in events]
    per = (groups.count("K1 resblock_conv3x3") / n,
           groups.count("K2 d2s_display_u8") / n)
    return prof, events, per


def check_replay(torch, name, engine, frames, device, n=REPLAY_FRAMES):
    """``n`` replayed frames, with a ``reset()`` after half of them,
    against eager ``run_step`` + display on a copy of the state: frames
    and states bit for bit."""
    from joshupscale_torch.runtime.engine import run_step

    model = engine.model
    engine.reset()
    state = model.init_state(device=device)
    for i in range(n):
        if i == n // 2:
            engine.reset()
            state = model.init_state(device=device)
        got = engine.process(frames[i % len(frames)])
        with torch.inference_mode():
            x = torch.from_numpy(frames[i % len(frames)][None]).to(device)
            ref = engine.display(run_step(model, engine.params, x, state))
        ref = ref.cpu().numpy()[0]
        same = [torch.equal(a, b) for a, b in zip(
            [engine.state["pre_gen"]] + engine.state["last_frames"],
            [state["pre_gen"]] + state["last_frames"])] if state else []
        if not np.array_equal(got, ref) or not all(same):
            raise AssertionError(
                f"{name}: replayed frame {i} differs from the eager step "
                f"(u8 max diff {np.abs(got.astype(int) - ref).max()}, "
                f"state tensors equal: {same})")
    log(f"{name}: {n} replayed frames (reset after {n // 2}) equal eager "
        f"run_step + display on a copy of the state bit for bit, frames "
        f"and states")


def check_graph_kernels(torch, name, engine, frames, device, k1_per_frame,
                        k2_per_frame):
    """A profile of replays shows the frame graph running the kernels
    it recorded at capture."""
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    _, _, per = replay_kernels(torch, engine, dev_frame)
    log(f"{name}: profiled replays run {per[0]:g} K1 and {per[1]:g} K2 "
        f"kernels each")
    if per != (k1_per_frame, k2_per_frame):
        raise AssertionError(f"{name}: a replay ran {per} K1/K2 kernels")


def drive_path(torch, name, config, seed, device, k1_per_frame,
               k2_per_frame, n_frames=FRAMES, ref_frames=REF_FRAMES,
               transform=None):
    """One serving path at full frame: the launch counts set to 0, the
    engine built (warm-up steps and the capture of the frame graph) and
    ``n_frames`` frames through ``Engine.process``; the counts read and
    the graph's recorded launches checked; the output checked; a step
    checked for synchronising calls; the first ``ref_frames`` frames
    held against the same engine on the CPU; replays held against eager
    steps.  ``transform`` makes the served params from the seeded float
    ones (``built.params``), e.g. ``quantize_params_int8``."""
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import WARMUP_STEPS, Engine

    t0 = time.perf_counter()
    built = create_models(config, seed=seed)["inference"]
    params = seeded_params(torch, built, seed)
    if transform is not None:
        params = transform(params)
    frames = frames_for(n_frames, seed)

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    engine = Engine(built.obj, params, device=device)
    outs = [engine.process(f) for f in frames]
    torch.cuda.synchronize()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    t = len(frames)
    steps = WARMUP_STEPS + 1
    log(f"{name}: engine built ({WARMUP_STEPS} warm-up steps, 1 captured) "
        f"and {t} frames through Engine.process (graph replays): K1 "
        f"launches={k1} ({k1 / steps:g}/step), K2 launches={k2} "
        f"({k2 / steps:g}/step), P1/P2 launches={p1}/{p2}; in the graph: "
        f"{engine.graph_launches}")
    want = {"resblock_conv3x3": k1_per_frame, "d2s_display_u8": k2_per_frame,
            "probe_dot": 0, "probe_patch_dot": 0}
    if (k1 != k1_per_frame * steps or k2 != k2_per_frame * steps or p1 or p2
            or engine.graph_launches != want):
        raise AssertionError(f"{name}: expected {k1_per_frame} K1 and "
                             f"{k2_per_frame} K2 a step, none while "
                             f"replaying and no P1/P2; got {k1}, {k2}, {p1}, "
                             f"{p2}, graph {engine.graph_launches}")
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    for o in outs:
        if o.shape != (4 * H, 4 * W, 3) or o.dtype != np.uint8:
            raise AssertionError(f"{name}: bad output {o.shape} {o.dtype}")
    inside = float(np.mean([((o > 0) & (o < 255)).mean() for o in outs]))
    log(f"{name}: output {outs[0].shape} uint8; share of values strictly "
        f"between 0 and 255: {inside:.4f}")
    if inside < 0.5:
        raise AssertionError(f"{name}: output mostly clipped: the check is "
                             f"trivial")

    # A step only enqueues work: any host<->device copy or other
    # synchronising call inside it raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.display(engine.step(dev_frame))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{name}: a replayed step and a display make no synchronising "
        f"call (torch.cuda.set_sync_debug_mode('error'))")

    # The same engine on the CPU (plain versions), same params and frames.
    cpu = Engine(built.obj, params, device="cpu")
    for i in range(ref_frames):
        card_vs_cpu(name, f"frame {i}", outs[i], cpu.process(frames[i]))
    check_replay(torch, name, engine, frames, device)
    log(f"{name}: phase took {time.perf_counter() - t0:.1f} s")
    return engine, frames, k1, k2, built


def card_vs_cpu(name, what, got, ref, against="CPU plain run"):
    """The card's u8 frame against the CPU's: bf16 on both sides,
    rounded at other places (cuDNN/cuBLAS vs oneDNN/MKL for the plain
    convs and products, the kernel's sum order): a few u8 steps where a
    flip propagates, rarely more.  Fails beyond mean 0.5 or 1% of the
    values off by more than 2.  ``against`` names another reference
    held to the same bound."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    mean_d, share = float(diff.mean()), float((diff > 2).mean())
    log(f"{name} vs {against}, {what}: u8 max diff {int(diff.max())}, "
        f"mean {mean_d:.4f}, share of values off by more than 2: "
        f"{share:.5f}")
    if mean_d > 0.5 or share > 0.01:
        raise AssertionError(f"{name} and {against} disagree beyond "
                             f"bound")
    return int(diff.max())


def time_frames(torch, name, engine, frames, device, n=TIMED_FRAMES):
    """Frame latency as a host sees it (blocking ``process``, copies
    included; the first 3 dropped), and the step (``time_steps``)."""
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        engine.process(frames[i % len(frames)])
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[3:])
    p80 = float(np.percentile(lat, 80))
    log(f"{name} Engine.process: median {np.median(lat):.3f} ms/frame, p80 "
        f"{p80:.3f} ms (n={lat.size}, blocking, host<->device copies "
        f"included)")
    return {"frame_ms": float(np.median(lat)), "frame_p80_ms": p80,
            **time_steps(torch, name, engine, frames, device)}


def time_steps(torch, name, engine, frames, device):
    """The step with its display (what the frame graph holds) eager
    against replayed, in turns: eager, replayed, replayed, eager, with
    CUDA events and the host's launch gaps included; then each on the
    device alone (a spin kernel lets the host enqueue ahead)."""
    from joshupscale_torch.runtime.engine import clone_state, run_step
    from joshupscale_torch.tools.timing import cuda_time_ms

    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    scratch = clone_state(engine.state)

    def eager():
        with torch.inference_mode():
            engine.display(run_step(engine.model, engine.params, dev_frame,
                                    scratch))

    def replayed():
        engine.step(dev_frame)

    fns = {"eager": eager, "replayed": replayed}
    host = {"eager": [], "replayed": []}
    for kind in ("eager", "replayed", "replayed", "eager"):
        host[kind].append(cuda_time_ms(fns[kind], reps=5, device_only=False))
    dev = {kind: cuda_time_ms(fn, reps=5) for kind, fn in fns.items()}
    log(f"{name} step + display (no copies), eager vs replayed graph in "
        f"turns, CUDA events with host launch gaps: eager "
        f"{host['eager'][0]:.3f} / {host['eager'][1]:.3f}, replayed "
        f"{host['replayed'][0]:.3f} / {host['replayed'][1]:.3f} ms/frame; "
        f"device only: eager {dev['eager']:.3f}, replayed "
        f"{dev['replayed']:.3f} ms/frame")
    return {"step_ms": float(np.median(host["replayed"])),
            "eager_ms": host["eager"], "replayed_ms": host["replayed"],
            "eager_device_ms": dev["eager"],
            "replayed_device_ms": dev["replayed"]}


def time_k1(torch, device, c, n=1):
    """K1's conv_1 (no residual) and conv_2 (residual) at (n, H, W, c)
    bf16 against the plain version, its bound and ``F.conv2d``."""
    import torch.nn.functional as F

    from joshupscale_torch.kernels.resblock import (
        resblock_conv3x3, resblock_conv3x3_plain)
    from joshupscale_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((n, H, W, c)).astype(
        np.float32) * 0.5).to(device, torch.bfloat16)
    res = torch.from_numpy(rng.standard_normal((n, H, W, c)).astype(
        np.float32)).to(device, torch.bfloat16)
    wt = torch.from_numpy(rng.standard_normal((c, 3, 3, c)).astype(
        np.float32) / np.sqrt(9 * c)).to(device, torch.bfloat16)
    s = torch.ones(c, device=device)
    o = torch.zeros(c, device=device)
    k1 = {}
    for name, r in (("conv_1", None), ("conv_2", res)):
        ms = cuda_time_ms(lambda: resblock_conv3x3(x, wt, s, o, r, "relu"),
                          reps=20)
        plain = cuda_time_ms(
            lambda: resblock_conv3x3_plain(x, wt, s, o, r, "relu"), reps=5)
        bound, by = k1_bound_ms(n, H, W, c, r is not None)
        k1[name] = (ms, plain, bound, by)
        log(f"K1 {name} ({n},{H},{W},{c}) bf16: {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{k1_flops(n, H, W, c) / (ms * 1e-3) / PEAK_BF16_FLOPS:.1%} of "
            f"the bf16 peak, {bound / ms:.1%} of the bound's rate")
    w_oihw = wt.permute(0, 3, 1, 2)
    x_nchw = x.permute(0, 3, 1, 2)  # channels-last memory
    lib_ms = cuda_time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1),
                          reps=20)
    log(f"library yardstick F.conv2d ({n},{H},{W},{c}) bf16 channels-last: "
        f"{lib_ms:.4f} ms")
    return k1, lib_ms


def phase_times(torch, engine, frames, device):
    """The quality tier's frame and step; K1 at C = 64, K2 (CUDA events,
    medians)."""
    from joshupscale_torch.kernels.display import (
        d2s_display_u8, d2s_display_u8_plain)
    from joshupscale_torch.tools.timing import cuda_time_ms

    torch.backends.cudnn.allow_tf32 = False
    tf = time_frames(torch, "quality", engine, frames, device)
    step_ms = tf["step_ms"]
    k1, lib_ms = time_k1(torch, device, 64)

    rng = np.random.default_rng(8)
    y = torch.from_numpy(np.clip(rng.standard_normal((1, H, W, 48)).astype(
        np.float32) * 0.3, -0.5, 0.5)).to(device, torch.bfloat16)
    k2_ms = cuda_time_ms(lambda: d2s_display_u8(y), reps=50)
    k2_plain = cuda_time_ms(lambda: d2s_display_u8_plain(y), reps=20)
    k2_bound = (H * W * 48 * 2 + H * W * 48) / PEAK_BYTES_PER_S * 1e3
    log(f"K2 (1,{H},{W},48) bf16: {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, "
        f"bound {k2_bound:.4f} ms (bytes)")

    k1_ms = (k1["conv_1"][0] + k1["conv_2"][0]) / 2
    log(f"where the quality step goes: K1 {K1_PER_FRAME} x {k1_ms:.4f} = "
        f"{K1_PER_FRAME * k1_ms:.3f} ms of the replayed {step_ms:.3f} ms; "
        f"the rest (first convs, heads, warp, tail, state copies, K2) "
        f"{step_ms - K1_PER_FRAME * k1_ms:.3f} ms")
    return {"k1": k1, "lib_ms": lib_ms, "k2": (k2_ms, k2_plain, k2_bound),
            **tf}


def phase_runtime(torch, config, engine, built, frames, device, k2_ms):
    """The runtime around the engine on the quality tier: process_async
    and process_clip against streamed process (bit for bit), a
    VideoStream on the card against the same stream on the CPU,
    NativeEngine.process_bytes on a package written by save_package
    against Engine.process (bit for bit); then process split into its
    parts, process_async throughput at max_inflight 1, 2 and 3, and
    Engine.benchmark by both methods."""
    import tempfile

    from joshupscale_torch.export.package import save_package
    from joshupscale_torch.runtime import Engine, VideoStream
    from joshupscale_torch.runtime.native_glue import NativeEngine

    t0 = time.perf_counter()
    clip = frames[:6]
    engine.reset()
    ref = np.stack([engine.process(f) for f in clip])
    engine.reset()
    outs = [engine.process_async(f) for f in clip]
    if not np.array_equal(np.stack([o.cpu().numpy()[0] for o in outs]), ref):
        raise AssertionError("process_async frames differ from process's")
    engine.reset()
    if not np.array_equal(engine.process_clip(clip), ref):
        raise AssertionError("process_clip differs from streamed process")
    log(f"runtime: process_async and process_clip equal streamed process "
        f"bit for bit ({len(clip)} frames each)")

    # One seek pattern on the card and on the CPU: warm-up lead-in,
    # a cache hit, a forward run.
    back, requests = 2, [0, 1, 2, 1, 5]
    cpu = Engine(engine.model, built.params, device="cpu")
    engine.reset()
    sides = [(e, e.frames_processed, VideoStream(
        e, lambda i: frames[i], num_frames=len(frames), max_backtrack=back))
        for e in (engine, cpu)]
    for n in requests:
        got, want = (stream.get_frame(n) for _, _, stream in sides)
        card_vs_cpu("VideoStream", f"frame {n}", got, want)
    calls = [e.frames_processed - before for e, before, _ in sides]
    log(f"runtime: VideoStream (max_backtrack {back}, requests {requests}) "
        f"on the card within bound of the CPU's; engine calls card/CPU "
        f"{calls[0]}/{calls[1]}")
    if calls[0] != calls[1] or calls[0] != 8:
        raise AssertionError(f"VideoStream made {calls} engine calls, not 8")
    del cpu, sides

    with tempfile.TemporaryDirectory() as d:
        save_package(d, config, built)
        native = NativeEngine(d, 0)
        engine.reset()
        for f in frames[:3]:
            got = native.process_bytes(f.tobytes())
            if got != engine.process(f).tobytes():
                raise AssertionError("NativeEngine.process_bytes differs from "
                                     "Engine.process")
        del native
    log("runtime: NativeEngine.process_bytes on a package written by "
        "save_package equals Engine.process bit for bit (3 frames)")

    # process = input copy + replay (step + display) + u8 copy + the rest,
    # host clock around each part with a sync after it; medians of 30.
    engine.reset()
    parts = {"input": [], "replay": [], "u8": [], "process": [],
             "input_host": []}
    for i in range(33):
        f = frames[i % len(frames)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = engine._as_input(f)
        t_host = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = engine._serve(x)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        engine.process(f)
        t5 = time.perf_counter()
        if i >= 3:
            for k, dt in zip(parts, (t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                     t_host - t1)):
                parts[k].append(dt * 1e3)
    split = {k: float(np.median(v)) for k, v in parts.items()}
    step = split["replay"] - k2_ms
    split["step"] = step
    split["display"] = k2_ms
    split["rest"] = split["process"] - split["input"] - split["replay"] - \
        split["u8"]
    log(f"runtime: Engine.process {split['process']:.3f} ms (median of 30, "
        f"host clock) exceeds the replayed step ({step:.3f} ms: replay "
        f"with a sync, K2 taken out) by {split['process'] - step:.3f} ms = "
        f"input copy (pinned staging + H2D; {split['input_host']:.3f} of it "
        f"before the sync) {split['input']:.3f} + display "
        f"(K2, in the graph) {k2_ms:.3f} + u8 copy to the host "
        f"{split['u8']:.3f} + the rest {split['rest']:.3f} ms")

    fps = {}
    for k in (1, 2, 3):
        e = Engine(engine.model, built.params, device=device, max_inflight=k)
        for f in frames[:3]:
            e.process_async(f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(50):
            e.process_async(frames[i % len(frames)])
        torch.cuda.synchronize()
        fps[k] = 50 / (time.perf_counter() - t1)
        del e
    log(f"runtime: process_async throughput over 50 frames (outputs left on "
        f"the device): " + ", ".join(
            f"max_inflight {k}: {v:.1f} frames/s ({1e3 / v:.3f} ms/frame)"
            for k, v in fps.items()))

    engine.reset()
    scan = engine.benchmark()
    per = engine.benchmark(method="per_dispatch")
    log(f"runtime: Engine.benchmark scan_diff (96 vs 16 frames of replays, "
        f"CUDA events) {scan['frame_ms']:.3f} ms/frame, {scan['fps']:.1f} "
        f"fps; per_dispatch (copy in, replay, wait; 96 after 16) p50 "
        f"{per['p50'] * 1e3:.3f} ms, p99 {per['p99'] * 1e3:.3f} ms, mean "
        f"{per['mean'] * 1e3:.3f} ms")
    log(f"runtime: phase took {time.perf_counter() - t0:.1f} s")
    return {"split": split, "async_fps": fps, "scan_diff": scan,
            "per_dispatch": per}


def kernel_group(name: str) -> str:
    """The part of a step a CUDA kernel belongs to, by its name."""
    low = name.lower()
    if "conv3x3" in name:
        return "K1 resblock_conv3x3"
    if "i16832gemm" in name or "imma" in low:
        return "int8 product (_int_mm)"
    if "reduce_kernel" in name:
        return "reductions (absmax, BN statistics)"
    if "indexfunc" in low or "index_add" in low:
        return "index_add (s2d warp backward)"
    if "multi_tensor_apply" in low:
        return "foreach (Adam, BN merge)"
    if "d2s_display" in name:
        return "K2 d2s_display_u8"
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


def profiled(torch, fn, trace_path=None):
    """``fn()`` under a ``torch.profiler`` session (CPU and CUDA
    activities), the card synchronized before and after: the profile and
    the device kernels, copies and fills of its trace (written to
    ``trace_path`` if given).  A session whose trace holds no device
    event is logged and run again, ``fn`` with it, up to
    ``PROFILE_SESSIONS`` sessions."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for session in range(1, PROFILE_SESSIONS + 1):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = trace_path or os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)["traceEvents"]
        events = [e for e in trace if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
        if events:
            return prof, events
        runtime = [e.get("name") for e in trace
                   if e.get("cat") == "cuda_runtime"]
        log(f"profiler session {session} of {PROFILE_SESSIONS} recorded no "
            f"device activity ({len(trace)} trace events; {len(runtime)} "
            f"CUDA runtime calls, {runtime.count('cudaGraphLaunch')} of them "
            f"cudaGraphLaunch)")
    raise RuntimeError(f"the profiler recorded no device activity in "
                       f"{PROFILE_SESSIONS} sessions")


def stages(torch, engine, frames, device):
    """The step's two stages alone, on the engine's state (not
    committed): the flow stage (preprocess, brightness, pad, flow net)
    and the generator stage (warp, generator, tail)."""
    model, params, state = engine.model, engine.params, engine.state
    x = torch.from_numpy(frames[0][None]).to(device)
    with torch.inference_mode():
        inter, _ = model.apply_flow_stage(
            params, x, {"last_frames": state["last_frames"]})

    def flow():
        with torch.inference_mode():
            model.apply_flow_stage(params, x,
                                   {"last_frames": state["last_frames"]})

    def gen():
        with torch.inference_mode():
            model.apply_gen_stage(params, inter, {"pre_gen": state["pre_gen"]})

    return {"flow stage": flow, "generator stage": gen}


def time_stages(torch, name, engine, frames, device):
    """Each stage timed alone: CUDA events, device only and with the
    host's launch gaps."""
    from joshupscale_torch.tools.timing import cuda_time_ms

    split = {}
    for stage, fn in stages(torch, engine, frames, device).items():
        split[stage] = {"ms": cuda_time_ms(fn, reps=5),
                        "host_ms": cuda_time_ms(fn, reps=5,
                                                device_only=False)}
        log(f"{name} {stage}: {split[stage]['ms']:.3f} ms/frame device "
            f"only, {split[stage]['host_ms']:.3f} ms with host launch gaps "
            f"(CUDA events)")
    return split


def profile_stages(torch, name, engine, frames, device, split):
    """Each stage profiled over 3 calls, kernels grouped by
    ``kernel_group``, into ``split``."""
    for stage, fn in stages(torch, engine, frames, device).items():
        _, events = profiled(torch, lambda: [fn() for _ in range(3)])
        groups = {}
        for e in events:
            key = kernel_group(e["name"])
            groups[key] = groups.get(key, 0.0) + e["dur"] / 3e3
        split[stage].update(groups=groups, ops=len(events) / 3)
        log(f"{name} {stage}: {len(events) / 3:.0f} device ops; profiled "
            f"device time by part: " + "; ".join(
                f"{k} {v:.3f}" for k, v in sorted(
                    groups.items(), key=lambda kv: -kv[1])))


def phase_ps2(torch, seed, device, paths):
    """The two PS2 tiers at full width: driven, checked, timed and their
    stages timed (each engine kept in ``paths`` for the profiler
    phases); K1 at C = 48 timed on the PS2-fast path."""
    out = {}
    for tier in ("ps2_style", "ps2_fast"):
        k1_per_frame = 2 * PS2_LADDERS[tier][2]
        engine, frames, k1, k2, _ = drive_path(
            torch, tier, ps2_config(tier), seed, device, k1_per_frame, 1)
        tf = time_frames(torch, tier, engine, frames, device, n=23)
        split = time_stages(torch, tier, engine, frames, device)
        out[tier] = {"k1": k1, "k2": k2, "split": split, **tf}
        paths[tier] = (engine, frames, k1_per_frame, 1)
    out["k1_c48"], out["lib_ms_c48"] = time_k1(torch, device, 48)
    return out


def phase_variants(torch, seed, device, paths):
    """Every serving option on the PS2-fast architecture at full frame:
    launches, output, sync, replay and card-vs-CPU checks as for the
    tiers (each engine kept in ``paths``)."""
    launches = {}
    for name, (options, k1_per_frame, k2_per_frame) in VARIANTS.items():
        engine, frames, k1, k2, _ = drive_path(
            torch, f"variant {name}", ps2_config("ps2_fast", **options),
            seed, device, k1_per_frame, k2_per_frame,
            n_frames=VARIANT_FRAMES, ref_frames=VARIANT_FRAMES)
        launches[name] = {"K1": k1, "K2": k2}
        paths[f"variant {name}"] = (engine, frames, k1_per_frame,
                                    k2_per_frame)
    return launches


def int8_vs_float(torch, name, engine, built, frames, device):
    """The int8 path's frames against the float tier's from the same
    (seeded float) params and frames: u8 mean difference and PSNR.
    Informational: int8 is another result, not a rounding of bf16."""
    from joshupscale_torch.runtime.engine import Engine

    float_engine = Engine(built.obj, built.params, device=device)
    engine.reset()
    a = np.stack([engine.process(f) for f in frames]).astype(np.float64)
    b = np.stack([float_engine.process(f) for f in frames]).astype(
        np.float64)
    del float_engine
    mse = float(((a - b) ** 2).mean())
    out = {"u8_mean_diff": float(np.abs(a - b).mean()),
           "psnr_db": float(10 * np.log10(255.0 ** 2 / mse)) if mse else
           float("inf")}
    log(f"{name} vs the bf16 tier (same params and {len(frames)} frames): "
        f"u8 mean diff {out['u8_mean_diff']:.4f}, PSNR "
        f"{out['psnr_db']:.2f} dB (informational)")
    return out


def phase_int8(torch, seed, device, paths):
    """The int8 tier at full frame (``quantize_params_int8`` of the
    seeded float params; every 3x3 C x C conv quantized, so 0 K1 and 1
    K2 a frame): the quality tier with dynamic activation scales, the
    quality tier with scales calibrated by ``calibrate(method="minmax")``
    over 4 frames on the card (and on the CPU, the two range maps
    compared), and ``ps2_style`` (the autoencoder's 256-channel convs: K
    = 2304, int32 sums past 2^24), each driven and checked as the float
    paths (launches from 0, sync, card vs CPU, replays vs eager), timed,
    and held against the float tier's frames (informational)."""
    from joshupscale_torch.export.quantize import (
        calibrate,
        quantize_params_int8,
    )

    out = {}

    def run(name, config, transform):
        engine, frames, k1, k2, built = drive_path(
            torch, name, config, seed, device, 0, 1,
            ref_frames=INT8_REF_FRAMES, transform=transform)
        out[name] = {"k1": k1, "k2": k2, **time_frames(
            torch, name, engine, frames, device, n=23),
            "vs_float": int8_vs_float(torch, name, engine, built,
                                      frames[:4], device)}
        paths[name] = (engine, frames, 0, 1)
        return built

    built = run("int8 quality", quality_config(), quantize_params_int8)
    cal = frames_for(4, seed + 1)[:, None]
    t0 = time.perf_counter()
    ranges = calibrate(built.obj, built.params, cal, method="minmax",
                       device=device)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranges_cpu = calibrate(built.obj, built.params, cal, method="minmax",
                           device="cpu")
    t_cpu = time.perf_counter() - t0
    # flow: conv_1, the head, 10 blocks; generator: conv_1, 24 blocks.
    if sorted(ranges) != sorted(ranges_cpu) or len(ranges) != 3 + 2 * 34:
        raise AssertionError(f"calibration keys differ: {len(ranges)} on "
                             f"the card, {len(ranges_cpu)} on the CPU")
    gap = max(abs(ranges[k] - ranges_cpu[k]) / ranges_cpu[k]
              for k in ranges)
    log(f"calibrate(minmax) over 4 frames: {len(ranges)} conv inputs "
        f"(flow.conv_1 ... generator.block_24.conv_2), card {t_card:.1f} s, "
        f"CPU {t_cpu:.1f} s; largest relative gap between the two range "
        f"maps {gap:.3g}")
    out["calibration"] = {"keys": len(ranges), "max_rel_gap": gap,
                          "card_s": t_card, "cpu_s": t_cpu}
    run("int8 quality calibrated", quality_config(),
        lambda p: quantize_params_int8(p, ranges=ranges))
    run("int8 ps2_style", ps2_config("ps2_style"), quantize_params_int8)
    return out


def time_process(fn, n=23):
    """Median and p80 ms of ``n`` blocking calls ``fn(i)`` (first 3
    dropped), host clock."""
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[3:])
    return float(np.median(lat)), float(np.percentile(lat, 80))


def phase_parallel(torch, seed, device, keep):
    """Multi-stream and pipelined serving of the quality tier on one
    card.  ``ShardedEngine(devices=[card], streams_per_device=2 and 4)``:
    launches from 0 (68 K1 + 1 K2 a step, K1 at N = 2 and 4), outputs
    against ``Engine(batch_size=2)`` bit for bit, every stream of the
    batch against the single-stream ``Engine`` on that stream's frames
    (the card-vs-CPU bound: a library conv or product may take another
    algorithm at another batch size; bit-exactness is printed), total
    and per-stream frames/s of ``process`` beside the single-stream
    ``Engine``.
    ``PipelinedEngine`` on (card, card): launches from 0 (the flow graph
    20 K1, the generator graph 48 K1 + 1 K2), its stream and
    ``process_clip`` against ``Engine``'s bit for bit, ``process``
    latency and ``process_async`` throughput beside ``Engine``'s.  The
    2-stream engine and a batch go into ``keep`` for the profiler."""
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.parallel import PipelinedEngine, ShardedEngine
    from joshupscale_torch.runtime.engine import WARMUP_STEPS, Engine

    from joshupscale_torch.tools.timing import cuda_time_ms

    built = create_models(quality_config(), seed=seed)["inference"]
    params = seeded_params(torch, built, seed)
    frames = frames_for(FRAMES, seed)
    nf = len(frames)
    kernels = all_kernels()
    steps = WARMUP_STEPS + 1
    single = Engine(built.obj, params, device=device)
    single_ms, single_p80 = time_process(
        lambda i: single.process(frames[i % nf]))
    res = {"single": {"ms": single_ms, "p80_ms": single_p80,
                      "fps": 1e3 / single_ms}}
    log(f"single-stream Engine.process: median {single_ms:.3f} ms, "
        f"{1e3 / single_ms:.1f} frames/s")
    for s in (2, 4):
        name = f"sharded x{s}"
        for k in kernels:
            k.launches = 0
        sharded = ShardedEngine(built.obj, params, devices=[device],
                                streams_per_device=s)
        batches = np.stack([frames[(np.arange(s) + t) % nf]
                            for t in range(nf)])
        outs = [sharded.process(b) for b in batches[:3]]
        torch.cuda.synchronize()
        k1, k2 = kernels[0].launches, kernels[1].launches
        want = {"resblock_conv3x3": K1_PER_FRAME, "d2s_display_u8": 1,
                "probe_dot": 0, "probe_patch_dot": 0}
        log(f"{name}: engine built and 3 steps of {s} streams: K1 "
            f"launches={k1}, K2 launches={k2}; in the graph: "
            f"{sharded.engines[0].graph_launches}")
        if (k1 != K1_PER_FRAME * steps or k2 != steps
                or sharded.engines[0].graph_launches != want):
            raise AssertionError(f"{name}: launches {k1}, {k2}")
        if s == 2:
            batched = Engine(built.obj, params, batch_size=2, device=device)
            for b, o in zip(batches[:3], outs):
                if not np.array_equal(batched.process(b), o):
                    raise AssertionError("ShardedEngine differs from "
                                         "Engine(batch_size=2)")
            del batched
            log(f"{name}: 3 steps equal Engine(batch_size=2) bit for bit")
        worst, exact = 0, 0
        for j in range(s):
            single.reset()
            ref = np.stack([single.process(b[j]) for b in batches[:3]])
            got = np.stack([o[j] for o in outs])
            exact += int(np.array_equal(got, ref))
            worst = max(worst, card_vs_cpu(
                name, f"stream {j}, 3 steps", got, ref,
                against="the single-stream Engine"))
        log(f"{name}: each stream within bound of the single-stream Engine "
            f"on its own frames; {exact} of {s} streams bit for bit, u8 "
            f"max diff {worst}")
        ms, p80 = time_process(lambda i: sharded.process(batches[i % nf]))
        inner = sharded.engines[0]
        dev_batch = torch.from_numpy(batches[0]).to(device)
        step_ms = cuda_time_ms(lambda: inner.step(dev_batch), reps=5,
                               device_only=False)
        res[name] = {"k1": k1, "k2": k2, "ms": ms, "p80_ms": p80,
                     "streams_exact": exact, "max_diff_vs_single": worst,
                     "step_ms": step_ms, "fps_total": s * 1e3 / ms,
                     "fps_per_stream": 1e3 / ms}
        log(f"{name}: process median {ms:.3f} ms (p80 {p80:.3f}) for {s} "
            f"frames: {s * 1e3 / ms:.1f} frames/s in all, "
            f"{1e3 / ms:.1f} per stream (single-stream Engine "
            f"{1e3 / single_ms:.1f}); replayed step of the {s}-stream "
            f"batch {step_ms:.3f} ms")
        if s == 2:
            keep[name] = (inner, dev_batch)
        del sharded

    for k in kernels:
        k.launches = 0
    piped = PipelinedEngine(built.obj, params, devices=(device, device))
    outs = [piped.process(f) for f in frames[:6]]
    torch.cuda.synchronize()
    k1, k2 = kernels[0].launches, kernels[1].launches
    log(f"pipelined: engine built (two graphs) and 6 frames: K1 launches="
        f"{k1}, K2 launches={k2}; in the graphs: {piped.graph_launches}")
    flow_k1 = 2 * 10
    if (k1 != K1_PER_FRAME * steps + flow_k1 or k2 != steps
            or piped.graph_launches["flow"]["resblock_conv3x3"] != flow_k1
            or piped.graph_launches["generator"] != {
                "resblock_conv3x3": K1_PER_FRAME - flow_k1,
                "d2s_display_u8": 1, "probe_dot": 0,
                "probe_patch_dot": 0}):
        raise AssertionError(f"pipelined: launches {k1}, {k2}")
    single.reset()
    ref = np.stack([single.process(f) for f in frames[:6]])
    if not np.array_equal(np.stack(outs), ref):
        raise AssertionError("PipelinedEngine differs from Engine")
    piped.reset()
    if not np.array_equal(piped.process_clip(frames[:6]), ref):
        raise AssertionError("PipelinedEngine.process_clip differs")
    log("pipelined: 6 streamed frames and process_clip equal Engine's bit "
        "for bit")
    lat = {"engine": [], "pipelined": []}
    engines = {"engine": single, "pipelined": piped}
    for kind in ("engine", "pipelined", "pipelined", "engine"):
        lat[kind].append(time_process(
            lambda i: engines[kind].process(frames[i % nf]))[0])
    fps = {}
    for kind, e in engines.items():
        for f in frames[:3]:
            e.process_async(f)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(50):
            e.process_async(frames[i % nf])
        torch.cuda.synchronize()
        fps[kind] = 50 / (time.perf_counter() - t1)
    log(f"pipelined on one card: process median {lat['pipelined'][0]:.3f} "
        f"/ {lat['pipelined'][1]:.3f} ms vs Engine {lat['engine'][0]:.3f} / "
        f"{lat['engine'][1]:.3f} ms (in turns); process_async over 50 "
        f"frames (max_inflight 2) {fps['pipelined']:.1f} vs Engine "
        f"{fps['engine']:.1f} frames/s")
    res["pipelined"] = {"k1": k1, "k2": k2, "ms": lat["pipelined"],
                        "engine_ms": lat["engine"],
                        "async_fps": fps["pipelined"],
                        "engine_async_fps": fps["engine"]}
    return res


def log_parts(torch, name, engine, dev_frame):
    """The device time of ``engine``'s replayed step by kernel group,
    from a profile of 3 replays."""
    _, events, _ = replay_kernels(torch, engine, dev_frame)
    groups = {}
    for e in events:
        key = kernel_group(e["name"])
        groups[key] = groups.get(key, 0.0) + e["dur"] / 3e3
    log(f"{name}: {len(events) / 3:.0f} device ops a replayed step, "
        f"{sum(groups.values()):.3f} ms of device time: " + "; ".join(
            f"{k} {v:.3f}" for k, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])))
    return groups


def phase_profiled(torch, paths, ps2, device, profile_dir, batched):
    """The phases under ``torch.profiler``, after every host-clock
    timing (a profiler session can leave the host launching more
    slowly): each path's replays counted by kernel; the PS2 stages split
    by kernel; with ``profile_dir``, each tier's replays profiled into
    it; then the quality step timed again, eager against replayed, to
    show the profiler's after-effect.  Also the device time of a step
    by part on quality, the int8 paths and the 2-stream batch
    (``batched``)."""
    for name, (engine, frames, k1_per_frame, k2_per_frame) in paths.items():
        check_graph_kernels(torch, name, engine, frames, device,
                            k1_per_frame, k2_per_frame)
    for tier in ("ps2_style", "ps2_fast"):
        engine, frames = paths[tier][:2]
        profile_stages(torch, tier, engine, frames, device,
                       ps2[tier]["split"])
    for name in ("quality", "int8 quality", "int8 ps2_style"):
        engine, frames = paths[name][:2]
        log_parts(torch, name, engine,
                  torch.from_numpy(frames[0][None]).to(device))
    for name, (engine, dev_batch) in batched.items():
        log_parts(torch, name, engine, dev_batch)
    if profile_dir:
        for tier in ("quality", "ps2_style", "ps2_fast"):
            engine, frames = paths[tier][:2]
            profile(torch, tier, engine, frames, device, profile_dir)
    engine, frames = paths["quality"][:2]
    return time_steps(torch, "quality (after the profiler sessions)",
                      engine, frames, device)


# FRVSR training: the models section of configs/frvsr_quality.yaml at
# full width, with zero_init_tail as configs/frvsr_synth.yaml sets it,
# and the configs' trainer shape (batch 4, T = 10, LR crop 32).
TRAIN_MODELS = {
    "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 64,
             "num_res_blocks": 10, "zero_init_tail": True},
    "generator": {"name": "generator-resnet", "num_filters": 64,
                  "num_res_blocks": 24, "zero_init_tail": True},
    "inference": {"name": "inference", "flow": {"model": "flow"},
                  "generator": {"model": "generator"},
                  "skip_processing": True, "frame_height": 32,
                  "frame_width": 32},
    "frvsr": {"name": "frvsr", "flow": {"model": "flow"},
              "generator": {"model": "generator"},
              "inference": {"model": "inference"}, "learning_rate": 0.0005},
}
TRAIN_BATCH, TRAIN_T, TRAIN_CROP = 4, 10, 32
TRAIN_EPOCHS, TRAIN_STEPS = 2, 3  # fit: epochs x steps, then validation
TRAIN_TIMED = 7  # timed steps per dtype, after 2 warm-up steps
# Card vs CPU, one float32 step (TF32 off in the step), written before
# the first run: the loss within 1e-4 relative, each gradient within
# 1e-3 relative L2 error.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3


def train_config(out_dir: str, compute_dtype: str) -> dict:
    models = json.loads(json.dumps(TRAIN_MODELS))
    models["frvsr"]["compute_dtype"] = compute_dtype
    return {
        "models": models,
        "train": {"model": "frvsr", "batch_size": TRAIN_BATCH,
                  "epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_STEPS,
                  "checkpoint_dir": os.path.join(out_dir, "ckpt"),
                  "tensorboard": False},
        "export": {"dir": os.path.join(out_dir, "export"),
                   "model": "inference",
                   "overrides": {"frame_height": H, "frame_width": W,
                                 "compute_dtype": "bfloat16"}},
    }


def train_batches(n: int, seed: int) -> list:
    """``n`` u8 batches {"input": (B, T, 32, 32, 3), "target": (B, T, 128,
    128, 3)}: smooth patterns moving at a random velocity plus noise,
    driven past 0 and 255 (saturated pixels), the LR the 4x4 mean of the
    HR."""
    rng = np.random.default_rng(seed)
    hs = 4 * TRAIN_CROP
    yy, xx = np.mgrid[0:hs, 0:hs].astype(np.float32)
    t = np.arange(TRAIN_T, dtype=np.float32)[None, :, None, None, None]
    out = []
    for _ in range(n):
        phase = rng.uniform(0, 2 * np.pi, (TRAIN_BATCH, 1, 1, 1, 3))
        vy, vx = (rng.uniform(-2, 2, (TRAIN_BATCH, 1, 1, 1, 1))
                  for _ in range(2))
        img = (np.sin((xx[..., None] + vx * t) * 0.05 + phase)
               * np.cos((yy[..., None] + vy * t) * 0.07 - phase))
        img = 127.5 + 170 * img + rng.standard_normal(img.shape) * 6
        hr = np.clip(img, 0, 255)
        lr = hr.reshape(TRAIN_BATCH, TRAIN_T, TRAIN_CROP, 4, TRAIN_CROP, 4,
                        3).mean((3, 5))
        out.append({"input": lr.astype(np.uint8),
                    "target": hr.astype(np.uint8)})
    return out


def count_syncs(torch, fn) -> int:
    """Synchronising calls ``fn()`` makes: each stalls the host until
    the card catches up."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def time_train_steps(torch, setup, batch, seed, base_bytes):
    """ms of an optimizer step (CUDA events around the step function)
    and of its forward, backward and optimizer parts (events between
    them), medians of ``TRAIN_TIMED`` steps after 2 warm-up steps, and
    the peak device memory of those steps above ``base_bytes`` (what was
    allocated before ``setup`` was built: the phases before keep their
    engines alive)."""
    from joshupscale_torch.training.trainer import (
        apply_gradients,
        exact_float32,
        grad_leaves,
        gradients,
    )

    trainer, state = setup.built.obj, setup.state
    gen = torch.Generator(setup.device).manual_seed(seed)
    noise = trainer.draw_noise(batch["input"].shape, gen, setup.device)
    exact = setup.step.exact_float32
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def split_step():
        e = [ev() for _ in range(4)]
        with exact_float32(exact):
            e[0].record()
            loss, aux = trainer.loss(state.params, batch, noise)
            e[1].record()
            grads = gradients(loss, grad_leaves(state.params))
            e[2].record()
            apply_gradients(setup.optimizer, state, grads, aux)
            e[3].record()
        return e

    for _ in range(2):
        split_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts, whole = [], []
    for _ in range(TRAIN_TIMED):
        e = split_step()
        a, b = ev(), ev()
        a.record()
        setup.step(state, batch, noise=noise)
        b.record()
        torch.cuda.synchronize()
        parts.append([e[i].elapsed_time(e[i + 1]) for i in range(3)])
        whole.append(a.elapsed_time(b))
    peak = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
    med = np.median(np.asarray(parts), axis=0)
    syncs = count_syncs(torch, lambda: setup.step(state, batch,
                                                  noise=noise))
    return {"step_ms": float(np.median(whole)), "syncs_per_step": syncs,
            "step_spread_ms": [float(min(whole)), float(max(whole))],
            "forward_ms": float(med[0]), "backward_ms": float(med[1]),
            "optimizer_ms": float(med[2]), "peak_gib": float(peak)}


def train_card_vs_cpu(torch, setup, batch_np, seed):
    """One float32 step's loss and every gradient on the card against the
    CPU, from the same initial params, batch and noise."""
    from joshupscale_torch.training.trainer import (
        device_normalize,
        exact_float32,
        init_train_state,
        loss_and_grads,
    )

    trainer = setup.built.obj
    noise = trainer.draw_noise(batch_np["input"].shape,
                               torch.Generator().manual_seed(seed), "cpu")
    def run(dev):
        params = init_train_state(setup.built.params, setup.optimizer,
                                  dev).params
        t0 = time.perf_counter()
        with exact_float32():
            loss, _, grads = loss_and_grads(
                trainer, params, device_normalize(batch_np, dev),
                {k: v.to(dev) for k, v in noise.items()})
        return (loss.item(), {p: g.detach().cpu().numpy()
                              for p, g in grads.items()},
                time.perf_counter() - t0)

    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = (
        run(setup.device), run(torch.device("cpu")))
    rel = {p: float(np.linalg.norm(g_card[p] - g_cpu[p])
                    / max(np.linalg.norm(g_cpu[p]), 1e-30)) for p in g_cpu}
    worst = max(rel, key=rel.get)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"train f32 card vs CPU (one step, {len(rel)} gradients; card "
        f"{s_card:.1f} s, CPU {s_cpu:.1f} s with the first call): loss "
        f"{l_card:.7f} vs {l_cpu:.7f} (relative {loss_rel:.2e}, bound "
        f"{TRAIN_LOSS_RTOL:g}); worst gradient relative L2 error "
        f"{rel[worst]:.2e} at {worst} (bound {TRAIN_GRAD_RTOL:g}), median "
        f"{float(np.median(list(rel.values()))):.2e}")
    if loss_rel > TRAIN_LOSS_RTOL or rel[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError("train: the card's f32 step disagrees with "
                             "the CPU's beyond the bound")
    return {"loss_rel": loss_rel, "worst_grad_rel": rel[worst],
            "worst_grad": worst}


def serve_trained(torch, name, config, setup, state, seed, device):
    """The trained params exported through the CLI's ``_export``
    (270x480, bf16) and served (``serve_package``)."""
    from joshupscale_torch.training.cli import _export

    _export(config["export"], config, setup.models, setup.built, state)
    return serve_package(torch, name,
                         os.path.join(config["export"]["dir"], "package"),
                         seed, device)


def serve_package(torch, name, package, seed, device):
    """A package served through ``create_runtime`` + ``Engine.process``
    with the launch counts set to 0 first: 68 K1 + 1 K2 a step, output
    not clipped flat, frames against the same package on the CPU,
    replays equal to eager steps.  Returns the launches and ``(engine,
    frames)``."""
    from joshupscale_torch.runtime.engine import WARMUP_STEPS, create_runtime

    frames = frames_for(FRAMES, seed)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    engine = create_runtime(package, device=device)
    outs = [engine.process(f) for f in frames]
    torch.cuda.synchronize()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    steps = WARMUP_STEPS + 1
    log(f"{name}: create_runtime + {len(frames)} frames through "
        f"Engine.process: K1 launches={k1} ({k1 / steps:g}/step), K2 "
        f"launches={k2} ({k2 / steps:g}/step), P1/P2 {p1}/{p2}; in the "
        f"graph: {engine.graph_launches}")
    if (k1 != K1_PER_FRAME * steps or k2 != steps or p1 or p2
            or engine.graph_launches["resblock_conv3x3"] != K1_PER_FRAME
            or engine.graph_launches["d2s_display_u8"] != 1):
        raise AssertionError(f"{name}: expected 68 K1 + 1 K2 a step")
    inside = float(np.mean([((o > 0) & (o < 255)).mean() for o in outs]))
    if any(o.shape != (4 * H, 4 * W, 3) for o in outs) or inside < 0.5:
        raise AssertionError(f"{name}: bad or clipped output")
    cpu = create_runtime(package, device="cpu")
    for i in range(2):
        card_vs_cpu(name, f"frame {i}", outs[i], cpu.process(frames[i]))
    check_replay(torch, name, engine, frames, device)
    return (k1, k2), (engine, frames)


def phase_train(torch, seed, device, out_dir):
    """FRVSR training at full width (``TRAIN_MODELS``: flow 64x10,
    generator 64x24; batch 4, T = 10, LR crop 32, u8 batches with
    saturated pixels) from the CLI's builder (``build_training``):
    ``fit`` for 2 epochs x 3 steps with a validation batch into a
    checkpoint directory (losses finite, the step counted, moving
    statistics moved, best and latest written, latest loaded back); one
    float32 step on the card against the CPU; steps timed in float32
    and bf16 (forward / backward / optimizer, peak memory); then the
    trained params exported through the CLI's ``_export`` (270x480,
    bf16) and served through ``create_runtime`` + ``Engine.process``
    with the launch counts set to 0 first: 68 K1 + 1 K2 a step, replays
    equal to eager steps, frames against the same package on the CPU.
    The training step itself launches no K1 or K2 (the reference trains
    on XLA convs; the port on library convs under autograd)."""
    import itertools

    from joshupscale_torch.training.cli import build_training
    from joshupscale_torch.export.weights import to_flat_numpy
    from joshupscale_torch.training.trainer import (
        device_normalize,
        fit,
        load_checkpoint,
    )

    t0 = time.perf_counter()
    batches = train_batches(TRAIN_EPOCHS * TRAIN_STEPS + 1, seed)
    sat = float(np.mean([(b["input"] == 0).mean() + (b["input"] == 255).mean()
                         for b in batches]))
    log(f"train: {len(batches)} u8 batches of {batches[0]['input'].shape} "
        f"-> {batches[0]['target'].shape}; share of saturated LR values "
        f"{sat:.4f}")
    if sat == 0:
        raise AssertionError("train: no saturated pixel in the batches")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    res = {}

    # fit, from the CLI's builder, float32.
    config = train_config(out_dir, "float32")
    setup = build_training(config, seed, device)
    ckpt = config["train"]["checkpoint_dir"]
    state, history = fit(
        setup.step, setup.state, itertools.cycle(batches[:-1]),
        epochs=TRAIN_EPOCHS, steps_per_epoch=TRAIN_STEPS,
        rng=torch.Generator(device).manual_seed(seed),
        val_fn=setup.val_fn, val_data=[batches[-1]], checkpoint_dir=ckpt,
        log_fn=lambda m: log(f"train fit: {m}"))
    losses = [e[k] for e in history for k in ("train_loss", "val_loss")]
    flat = to_flat_numpy(state.params)
    last = TRAIN_MODELS["generator"]["num_res_blocks"]
    moved = {p: float(np.abs(flat[p] - (0.0 if p.endswith("mean") else 1.0))
                      .max()) for p in ("flow.bn_1.moving_mean",
                                        f"generator.block_{last}.bn_2."
                                        "moving_variance")}
    loaded = load_checkpoint(os.path.join(ckpt, "latest.npz"), state.tree())
    same = all(np.array_equal(v, flat[p]) for p, v in
               to_flat_numpy(loaded["params"]).items())
    log(f"train fit: {len(history)} epochs, step {state.step}, losses "
        f"{['%.5f' % x for x in losses]}; moving statistics moved by "
        f"{moved}; best.npz {os.path.exists(os.path.join(ckpt, 'best.npz'))}"
        f", latest.npz loads back equal: {same}")
    if (len(history) != TRAIN_EPOCHS or not np.all(np.isfinite(losses))
            or state.step != TRAIN_EPOCHS * TRAIN_STEPS
            or min(moved.values()) == 0 or not same
            or not os.path.exists(os.path.join(ckpt, "best.npz"))):
        raise AssertionError("train: fit did not run as expected")
    res["fit_losses"] = losses

    res["card_vs_cpu"] = train_card_vs_cpu(torch, setup, batches[0], seed)

    dev_batch = device_normalize(batches[0], device)
    for dtype in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        timed = build_training(train_config(out_dir, dtype), seed, device)
        res[dtype] = time_train_steps(torch, timed, dev_batch, seed, base)
        del timed
        torch.cuda.empty_cache()

    k1, k2, p1, p2 = (k.launches for k in kernels)
    log(f"train: launches over fit, the card-vs-CPU step and the timed "
        f"steps: K1 {k1}, K2 {k2}, P1 {p1}, P2 {p2}")
    if k1 or k2 or p1 or p2:
        raise AssertionError("train: a kernel launched in a train step")

    res["export_launches"], res["engine"] = serve_trained(
        torch, "trained export", config, setup, state, seed, device)
    log(f"train: phase took {time.perf_counter() - t0:.1f} s")
    return res


def profile_train(torch, seed, device, step_ms, label="train",
                  build=None):
    """Device time of a full-width train step by kernel group, from a
    profile of 2 steps after 2 warm-up steps, in float32 and bf16; the
    idle share against the unprofiled step median (``step_ms``).
    ``build(dtype)`` makes the setup (default: the FRVSR phase's)."""
    from joshupscale_torch.training.cli import build_training
    from joshupscale_torch.training.trainer import device_normalize

    if build is None:
        def build(dtype):
            return build_training(train_config("unused", dtype), seed,
                                  device)

    batch_np = train_batches(1, seed)[0]
    out = {}
    for dtype in ("float32", "bfloat16"):
        setup = build(dtype)
        batch = device_normalize(batch_np, device)
        noise = setup.built.obj.draw_noise(
            batch["input"].shape, torch.Generator(device).manual_seed(seed),
            device)
        def steps():
            for _ in range(2):
                setup.step(setup.state, batch, noise=noise)

        steps()
        _, events = profiled(torch, steps)
        groups = {}
        for e in events:
            key = kernel_group(e["name"])
            groups[key] = groups.get(key, 0.0) + e["dur"] / 2e3
        busy = sum(groups.values())
        idle = 1 - busy / step_ms[dtype]
        log(f"{label} {dtype}: {len(events) / 2:.0f} device ops a step, "
            f"{busy:.2f} ms of device time against the {step_ms[dtype]:.2f}"
            f" ms step (idle share {idle:.3f}): " + "; ".join(
                f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                                  key=lambda kv: -kv[1])))
        out[dtype] = {"ops": len(events) / 2, "busy_ms": busy,
                      "idle_share": idle, "groups": groups}
        del setup
        torch.cuda.empty_cache()
    return out


# TecoGAN training: the models section of configs/gan_synth_learn.yaml
# without its ``weights:`` lines (the FRVSR checkpoints they name are not
# in the repository), at its trainer shape (batch 4, T = 10, LR crop 32,
# lr 5e-5, its loss_config).
GAN_MODELS = {
    "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 64,
             "num_res_blocks": 10},
    "generator": {"name": "generator-resnet", "num_filters": 64,
                  "num_res_blocks": 24},
    "discriminator": {"name": "discriminator", "alpha": 0.25},
    "vgg": {"name": "vgg"},
    "inference": {"name": "inference", "flow": {"model": "flow"},
                  "generator": {"model": "generator"},
                  "skip_processing": True, "frame_height": 32,
                  "frame_width": 32},
    "gan": {"name": "gan", "flow": {"model": "flow"},
            "generator": {"model": "generator"},
            "discriminator": {"model": "discriminator"},
            "vgg": {"model": "vgg"}, "inference": {"model": "inference"},
            "learning_rate": 0.00005,
            "loss_config": {"content_loss": 1.0, "pp_loss": 0.5,
                            "warp_loss": 1.0, "adv_loss": 0.1,
                            "discr_layer_loss": 0.2, "vgg_loss": 0.2,
                            "t_balance1_threshold": 0.2,
                            "t_balance2_threshold": 0.0}},
}
GAN_EPOCHS, GAN_STEPS = 2, 2  # fit: epochs x steps, then validation
GAN_TIMED = 5  # timed steps per dtype, after 2 warm-up steps
GAN_PLAY = 2  # play clips (the config's play_size)
# The card-vs-CPU step's batch (the CPU side at batch 4 is the phase's
# longest part; cut here, for this check only, where it runs over ~60 s).
GAN_CHECK_BATCH = 4
# Card vs CPU, one float32 step (TF32 off), written before the first
# run: each loss term within 1e-4 relative, each gradient of both groups
# within 1e-3 relative L2; the play prediction within 1e-3.  The first
# run showed the generator group's gradients move by 4% on the card
# alone under a 1e-7 relative nudge of the first convs' kernels (the
# warp's gradient in the flow jumps where a flow crosses an integer, and
# the 19-step sums cancel), as far as card and CPU differ: so each
# group is held to the larger of 1e-3 and 3x its largest change under
# three such nudges (``GAN_NUDGES``), and the 1e-3 verdict is printed.
GAN_LOSS_RTOL, GAN_GRAD_RTOL, GAN_PLAY_ATOL = 1e-4, 1e-3, 1e-3
GAN_NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 2e-7)
# Launches of one play prediction: 2 per res block of both nets, 18
# playback steps.
K1_PER_PLAY = K1_PER_FRAME * 18


def gan_config(out_dir: str, compute_dtype: str) -> dict:
    models = json.loads(json.dumps(GAN_MODELS))
    models["gan"]["compute_dtype"] = compute_dtype
    return {
        "models": models,
        "train": {"model": "gan", "batch_size": TRAIN_BATCH,
                  "epochs": GAN_EPOCHS, "steps_per_epoch": GAN_STEPS,
                  "play_size": GAN_PLAY,
                  "checkpoint_dir": os.path.join(out_dir, "gan_ckpt"),
                  "tensorboard": False},
        "export": {"dir": os.path.join(out_dir, "gan_export"),
                   "model": "inference",
                   "overrides": {"frame_height": H, "frame_width": W,
                                 "compute_dtype": "bfloat16"}},
    }


def damp_gan(torch, gen_params):
    """In place, as a stand-in for the FRVSR-pretrained weights the
    config starts from: each res block's residual branch (bn_2 gamma)
    x0.2 and the two heads x0.3, so activations stay O(1) through 24
    blocks and the 19-step recurrence does not amplify round-off."""
    with torch.no_grad():
        for net in ("flow", "generator"):
            for k, v in gen_params[net].items():
                if k.startswith("block_"):
                    v["bn_2"]["gamma"].mul_(0.2)
        gen_params["flow"]["conv_2"]["kernel"].mul_(0.3)
        gen_params["generator"]["conv_trans_2"]["kernel"].mul_(0.3)


def build_gan(torch, config, seed, device):
    """``build_training`` for the GAN config, its generator group damped
    (``damp_gan``) in the registry's params and in the fresh state."""
    from joshupscale_torch.training.cli import build_training

    setup = build_training(config, seed, device)
    damp_gan(torch, setup.built.params["gen"])
    damp_gan(torch, setup.state.gen_params)
    return setup


def gan_pull(torch, setup, batch, noise, dev, nudge=None):
    """One float32 GAN step from the registry's params on ``dev``: the
    loss terms, both groups' gradients (host numpy), the gate decision
    and ``discr_steps``, and the seconds it took.  ``nudge`` scales the
    first convs' kernels (a conditioning probe)."""
    from joshupscale_torch.training.trainer import (
        apply_gan_gradients,
        device_normalize,
        exact_float32,
        gan_gradients,
        gan_losses,
        init_gan_state,
        make_optimizer,
        to_device,
    )

    built, trainer = setup.built, setup.built.obj
    gopt, dopt = make_optimizer(5e-5), make_optimizer(5e-5)
    state = init_gan_state(trainer, built.params["gen"],
                           built.params["discr"], gopt, dopt, dev)
    if nudge is not None:
        with torch.no_grad():
            for net in ("flow", "generator"):
                state.gen_params[net]["conv_1"]["kernel"].mul_(nudge)
    t0 = time.perf_counter()
    with exact_float32():
        terms, upd = gan_losses(trainer, state, device_normalize(batch, dev),
                                {k: v.to(dev) for k, v in noise.items()},
                                to_device(built.params["vgg"], dev))
        grads = gan_gradients(terms, state)
        trained = apply_gan_gradients(
            trainer, gopt, dopt, state, *grads, terms, upd,
            trainer.config()["t_balance1_threshold"])
    out = ({k: v.item() for k, v in terms.items()},
           [{p: g.detach().cpu().numpy() for p, g in group.items()}
            for group in grads], trained, state.ema["discr_steps"])
    return out + (time.perf_counter() - t0,)


def gan_card_vs_cpu(torch, setup, batch_np, seed):
    """One float32 step on the card against the CPU from the same params,
    batch and noise: every loss term, every gradient of both groups, the
    gate decision and ``discr_steps``.  The gradients are held to
    ``GAN_GRAD_RTOL`` or 3x the card's own largest change under the
    ``GAN_NUDGES`` of the first convs' kernels, whichever is larger."""
    trainer = setup.built.obj
    b = GAN_CHECK_BATCH
    batch_np = {k: v[:b] for k, v in batch_np.items()}
    if b != TRAIN_BATCH:
        log(f"gan card vs CPU: batch cut to {b} for this check")
    noise = trainer.draw_noise(batch_np["input"].shape,
                               torch.Generator().manual_seed(seed), "cpu")
    card = gan_pull(torch, setup, batch_np, noise, setup.device)
    nudged = [gan_pull(torch, setup, batch_np, noise, setup.device, n)
              for n in GAN_NUDGES]
    cpu = gan_pull(torch, setup, batch_np, noise, torch.device("cpu"))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    loss_rel = {k: abs(card[0][k] - v) / max(abs(v), 1e-30)
                for k, v in cpu[0].items()}
    worst_loss = max(loss_rel, key=loss_rel.get)
    res = {"loss_rel": loss_rel, "batch": b, "cpu_s": cpu[4],
           "card_s": card[4]}
    for i, group in enumerate(("gen", "discr")):
        errs = {p: rel(card[1][i][p], g) for p, g in cpu[1][i].items()}
        self_rel = max(rel(n[1][i][p], g) for n in nudged
                       for p, g in card[1][i].items() if np.any(g))
        bound = max(GAN_GRAD_RTOL, 3 * self_rel)
        worst = max(errs, key=errs.get)
        log(f"gan f32 card vs CPU, {group} group ({len(errs)} gradients): "
            f"worst relative L2 {errs[worst]:.2e} at {worst}, median "
            f"{float(np.median(list(errs.values()))):.2e}; within "
            f"{GAN_GRAD_RTOL:g}: {errs[worst] <= GAN_GRAD_RTOL}; the card's "
            f"own largest change under {len(GAN_NUDGES)} nudges of the "
            f"first convs' kernels by 1e-7: {self_rel:.2e}, bound "
            f"{bound:.2e}")
        res[f"{group}_worst_grad_rel"] = errs[worst]
        res[f"{group}_worst_grad"] = worst
        res[f"{group}_self_rel"] = self_rel
        res[f"{group}_bound"] = bound
    log(f"gan f32 card vs CPU (batch {b}; card {card[4]:.1f} s, CPU "
        f"{cpu[4]:.1f} s): worst loss term {worst_loss} relative "
        f"{loss_rel[worst_loss]:.2e} (bound {GAN_LOSS_RTOL:g}); "
        f"gen_loss {card[0]['gen_loss']:.7f} vs {cpu[0]['gen_loss']:.7f}; "
        f"gate open on card / CPU: {card[2]} / {cpu[2]}, discr_steps "
        f"{card[3]} / {cpu[3]}")
    if (loss_rel[worst_loss] > GAN_LOSS_RTOL
            or res["gen_worst_grad_rel"] > res["gen_bound"]
            or res["discr_worst_grad_rel"] > res["discr_bound"]
            or card[2] != cpu[2] or card[3] != cpu[3]):
        raise AssertionError("gan: the card's f32 step disagrees with the "
                             "CPU's beyond the bound")
    return res


def gan_gate_shut(torch, setup, state, batch):
    """One step with ``ema["t_balance1"]`` forced to 1.0: the
    discriminator's params (the moving statistics aside) and its Adam
    moments unchanged bit for bit, its count and ``discr_steps`` too."""
    params = {p: v.detach().clone() for p, v in
              trainable_paths(state.discr_params)}
    moments = {(m, p): v.clone() for m in ("mu", "nu") for p, v in
               trainable_paths(state.discr_opt_state[m])}
    count, steps = state.discr_opt_state["count"], state.ema["discr_steps"]
    gen_count = state.gen_opt_state["count"]
    state.ema["t_balance1"] = torch.ones((), device=setup.device)
    state, metrics = setup.step(state, batch,
                                rng=torch.Generator(setup.device)
                                .manual_seed(1))
    same = (all(torch.equal(v, dict(trainable_paths(
        state.discr_params))[p]) for p, v in params.items())
        and all(torch.equal(v, dict(trainable_paths(
            state.discr_opt_state[m]))[p]) for (m, p), v in moments.items()))
    log(f"gan gate shut (t_balance1 EMA 1.0 before the step): "
        f"discriminator params and Adam moments unchanged bit for bit: "
        f"{same}; count {count} -> {state.discr_opt_state['count']}, "
        f"discr_steps {steps} -> {state.ema['discr_steps']}, generator "
        f"count {gen_count} -> {state.gen_opt_state['count']}")
    if (not same or state.discr_opt_state["count"] != count
            or state.ema["discr_steps"] != steps
            or state.gen_opt_state["count"] != gen_count + 1):
        raise AssertionError("gan: a shut gate moved the discriminator")
    return state


def trainable_paths(tree, path=""):
    """``(dotted path, tensor)`` of a tree's leaves outside the moving
    statistics."""
    for k, v in tree.items():
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            yield from trainable_paths(v, p)
        elif not k.startswith("moving_"):
            yield p, v


def time_gan_steps(torch, setup, batch, seed, base_bytes):
    """ms of a GAN step and of its forward (both nets, losses), backward
    (the two pulls) and optimizer (both Adams, the gate's host read, the
    BN merges) parts, CUDA events between them, medians of
    ``GAN_TIMED`` steps after 2 warm-up steps; peak device memory above
    ``base_bytes``; synchronising calls in one step."""
    from joshupscale_torch.training.trainer import (
        apply_gan_gradients,
        exact_float32,
        gan_gradients,
        gan_losses,
        to_device,
    )

    trainer, state = setup.built.obj, setup.state
    vgg = to_device(setup.built.params["vgg"], setup.device)
    noise = trainer.draw_noise(batch["input"].shape,
                               torch.Generator(setup.device).manual_seed(seed),
                               setup.device)
    threshold = trainer.config()["t_balance1_threshold"]
    exact = setup.step.exact_float32
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def split_step():
        e = [ev() for _ in range(4)]
        with exact_float32(exact):
            e[0].record()
            terms, upd = gan_losses(trainer, state, batch, noise, vgg)
            e[1].record()
            grads = gan_gradients(terms, state)
            e[2].record()
            apply_gan_gradients(trainer, setup.optimizer,
                                setup.discr_optimizer, state, *grads,
                                terms, upd, threshold)
            e[3].record()
        return e

    for _ in range(2):
        split_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts, whole = [], []
    for _ in range(GAN_TIMED):
        e = split_step()
        torch.cuda.synchronize()
        parts.append([e[i].elapsed_time(e[i + 1]) for i in range(3)])
        whole.append(e[0].elapsed_time(e[3]))
    peak = (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 30
    med = np.median(np.asarray(parts), axis=0)
    syncs = count_syncs(torch, lambda: setup.step(state, batch,
                                                  noise=noise))
    return {"step_ms": float(np.median(whole)), "syncs_per_step": syncs,
            "step_spread_ms": [float(min(whole)), float(max(whole))],
            "forward_ms": float(med[0]), "backward_ms": float(med[1]),
            "optimizer_ms": float(med[2]), "peak_gib": float(peak),
            "discr_steps": state.ema["discr_steps"], "steps": state.step}


def phase_gan(torch, seed, device, out_dir):
    """TecoGAN training at full width (``GAN_MODELS``: flow 64x10,
    generator 64x24, discriminator alpha 0.25, VGG19 with seeded random
    weights; batch 4, T = 10 -> the 19-frame ping-pong, LR crop 32; u8
    batches with saturated pixels) from the CLI's ``build_training``
    (the generator group damped by ``damp_gan``):
    ``fit`` for 2 epochs x 2 steps with a validation batch into a
    checkpoint directory, the play callback's prediction each epoch
    (``PlayCallback.predict``: ``predict_sequence`` + ``build_strips``
    on the card, through K1 in float32; no GIF), checked against the CPU;
    one float32 step on the card against the CPU; the gate forced shut
    for one step; steps timed in float32 and bf16; then the generator
    group exported and served as the FRVSR phase serves its export.  The
    train steps launch no K1 or K2."""
    import itertools

    from joshupscale_torch.export.weights import to_flat_numpy
    from joshupscale_torch.training.play import (
        PlayCallback,
        predict_sequence,
    )
    from joshupscale_torch.training.trainer import (
        device_normalize,
        fit,
        load_checkpoint,
    )

    t0 = time.perf_counter()
    batches = train_batches(GAN_EPOCHS * GAN_STEPS + 1, seed)
    kernels = all_kernels()
    config = gan_config(out_dir, "float32")
    setup = build_gan(torch, config, seed, device)
    ckpt = config["train"]["checkpoint_dir"]
    inference = setup.built.config["inference"]
    play_batch = {k: v[:GAN_PLAY] for k, v in batches[-1].items()}
    play = PlayCallback(inference.obj, play_batch, "unused", device=device)
    strips = []
    for k in kernels:
        k.launches = 0
    state, history = fit(
        setup.step, setup.state, itertools.cycle(batches[:-1]),
        epochs=GAN_EPOCHS, steps_per_epoch=GAN_STEPS,
        rng=torch.Generator(device).manual_seed(seed),
        val_fn=setup.val_fn, val_data=[batches[-1]], checkpoint_dir=ckpt,
        monitor=setup.monitor,
        epoch_callback=lambda e, st, entry: strips.append(play.predict(st)),
        log_fn=lambda m: log(f"gan fit: {m}"))
    torch.cuda.synchronize()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    log(f"gan fit: launches over {GAN_EPOCHS * GAN_STEPS} steps, "
        f"{GAN_EPOCHS} validations and {len(strips)} play predictions: K1 "
        f"{k1} (play: {K1_PER_PLAY} a prediction, f32), K2 {k2}, P1/P2 "
        f"{p1}/{p2}")
    if (k1 != K1_PER_PLAY * len(strips) or k2 or p1 or p2
            or len(strips) != GAN_EPOCHS):
        raise AssertionError("gan: the train steps launched a kernel, or "
                             "the play prediction missed K1")
    res = {"play_k1": k1 // len(strips), "fit_k1": k1}
    losses = [e[k] for e in history
              for k in ("train_gen_loss", "train_discr_loss",
                        "val_content_loss")]
    flat = to_flat_numpy(state.gen_params)
    dflat = to_flat_numpy(state.discr_params)
    moved = {"gen.flow.bn_1.moving_mean": float(np.abs(
        flat["flow.bn_1.moving_mean"]).max()),
        "discr.block_4.bn.moving_variance": float(np.abs(
            dflat["block_4.bn.moving_variance"] - 1).max())}
    loaded = load_checkpoint(os.path.join(ckpt, "latest.npz"), state.tree())
    same = (all(np.array_equal(v, flat[p]) for p, v in
                to_flat_numpy(loaded["gen_params"]).items())
            and all(np.array_equal(v, dflat[p]) for p, v in
                    to_flat_numpy(loaded["discr_params"]).items())
            and loaded["ema"]["discr_steps"] == state.ema["discr_steps"])
    log(f"gan fit: {len(history)} epochs, step {state.step}, discr_steps "
        f"{state.ema['discr_steps']}, t_balance1 EMA "
        f"{float(state.ema['t_balance1']):.5f}; gen / discr / val content "
        f"losses {['%.5f' % x for x in losses]}; moving statistics moved "
        f"by {moved}; latest.npz loads back equal: {same}")
    if (len(history) != GAN_EPOCHS or not np.all(np.isfinite(losses))
            or state.step != GAN_EPOCHS * GAN_STEPS
            or min(moved.values()) == 0 or not same
            or not os.path.exists(os.path.join(ckpt, "best.npz"))):
        raise AssertionError("gan: fit did not run as expected")
    res["fit_losses"] = losses

    # The play prediction on the card against the CPU, same params.
    cpu_pred = predict_sequence(
        play.model, to_cpu(torch, play.params_of(state)), play.inputs.cpu(),
        play.targets.cpu())
    diff = np.abs(strips[-1]["gen_outputs"]
                  - cpu_pred["gen_outputs"].numpy())
    log(f"gan play: predict_sequence + build_strips on the card "
        f"({GAN_PLAY} clips, 18 frames of {4 * TRAIN_CROP}x"
        f"{4 * TRAIN_CROP}, comparison strips "
        f"{strips[-1]['comparison'].shape}) vs the CPU: max abs "
        f"{diff.max():.2e}, mean {diff.mean():.2e} (bound "
        f"{GAN_PLAY_ATOL:g})")
    if diff.max() > GAN_PLAY_ATOL:
        raise AssertionError("gan: the play prediction disagrees with the "
                             "CPU's")
    res["play_max_diff"] = float(diff.max())

    for k in kernels:
        k.launches = 0
    res["card_vs_cpu"] = gan_card_vs_cpu(torch, setup, batches[0], seed)
    dev_batch = device_normalize(batches[0], device)
    state = gan_gate_shut(torch, setup, state, dev_batch)
    for dtype in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        timed = build_gan(torch, gan_config(out_dir, dtype), seed, device)
        res[dtype] = time_gan_steps(torch, timed, dev_batch, seed, base)
        del timed
        torch.cuda.empty_cache()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    log(f"gan: launches over the card-vs-CPU step, the gate-shut step and "
        f"the timed steps: K1 {k1}, K2 {k2}, P1 {p1}, P2 {p2}")
    if k1 or k2 or p1 or p2:
        raise AssertionError("gan: a kernel launched in a train step")

    res["export_launches"], res["engine"] = serve_trained(
        torch, "gan export", config, setup, state, seed, device)
    log(f"gan: phase took {time.perf_counter() - t0:.1f} s")
    return res


MESH_DEVICES = ["cuda:0", "cuda:0"]  # two gloo ranks share the card
MESH_STEPS = 2
# The GAN step's gen_loss, mesh against one process: the bound of the
# reference's own full-architecture data-parallel check
# (tests/test_full_arch_multichip.py).
MESH_GEN_LOSS_RTOL = 2e-3


def mesh_package(name, models, flat, out_dir):
    """A serving package (270x480, bf16, u8 frames) of the FRVSR nets'
    params ``flat`` (a mesh run's, flat numpy) at ``out_dir/name``."""
    from joshupscale_torch.export.package import save_package
    from joshupscale_torch.export.weights import from_flat_numpy
    from joshupscale_torch.models.registry import create_models

    cfg = {n: dict(models[n]) for n in ("flow", "generator", "inference")}
    cfg["inference"].update(frame_height=H, frame_width=W,
                            compute_dtype="bfloat16",
                            skip_processing=False)
    built = create_models(cfg, seed=0)["inference"]
    built.params = from_flat_numpy({k: v for k, v in flat.items()
                                    if k.split(".")[0] in ("flow",
                                                           "generator")})
    path = os.path.join(out_dir, name)
    save_package(path, cfg, built)
    return path


def mesh_nudge(flat, factor):
    """Flat FRVSR params with the first convs' kernels scaled by
    ``factor``."""
    out = dict(flat)
    for net in ("flow", "generator"):
        key = f"{net}.conv_1.kernel"
        out[key] = flat[key] * np.float32(factor)
    return out


def phase_mesh(torch, seed, device, out_dir):
    """The data-parallel mesh (``parallel.mesh``): full-width FRVSR
    (``TRAIN_MODELS``, float32, global batch 4, T = 10, crop 32) for
    ``MESH_STEPS`` steps on 2 gloo ranks sharing the card, against the
    same steps in this process on the same global batches and noise
    (``tools.mesh_parity``): the loss within ``TRAIN_LOSS_RTOL``, every
    all-reduced gradient against the one-process gradient at the ranks'
    params (``replay_grads``) within the larger of ``TRAIN_GRAD_RTOL``
    and 3x the one-process step's own change there under the
    ``GAN_NUDGES`` of the first convs' kernels (after the first update
    the flow heads are off zero and the warp's gradient jumps where a
    flow crosses an integer, as in the GAN phase), the params within
    ``2 * lr * steps``, the ranks' params bit for bit; one GAN step
    (``GAN_MODELS``, damped, float32) the same way: the same gate
    decision, the EMAs printed, gen_loss within
    ``MESH_GEN_LOSS_RTOL``; then rank 0's FRVSR params served as a
    package with the counts set to 0 (68 K1 + 1 K2 a step), its frames
    against the one-process params' package.  One launch runs both mesh
    runs; the rank spawn time is rank 0's entry into its first run less
    the launch's start."""
    from joshupscale_torch.export.weights import to_flat_numpy
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.parallel.mesh import launch
    from joshupscale_torch.runtime.engine import create_runtime
    from joshupscale_torch.tools import mesh_parity as mp
    from joshupscale_torch.training.frvsr import draw_recurrent_noise

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)

    def noises(n, batch):
        return [{k: v.numpy() for k, v in draw_recurrent_noise(
            4, batch["input"].shape, gen, "cpu").items()} for _ in range(n)]

    models = json.loads(json.dumps(TRAIN_MODELS))
    models["frvsr"]["compute_dtype"] = "float32"
    batches = train_batches(MESH_STEPS, seed)
    frvsr = mp.Run(models, "frvsr", batches,
                   noises(MESH_STEPS, batches[0]), seed=seed)
    gan_models = gan_config("unused", "float32")["models"]
    gan_built = create_models(gan_models, seed=seed)["gan"]
    damp_gan(torch, gan_built.params["gen"])
    gan_batch = train_batches(1, seed + 1)
    gan = mp.Run(gan_models, "gan", gan_batch, noises(1, gan_batch[0]),
                 params={g: to_flat_numpy(gan_built.params[g])
                         for g in ("gen", "discr")}, seed=seed)
    del gan_built
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    launched = time.time()
    probed = launch(mp.run_and_probe, len(MESH_DEVICES), [frvsr, gan],
                    devices=MESH_DEVICES)
    meshed = probed["runs"]
    spawn_s = meshed[0]["started"] - launched
    launch_s = time.time() - launched
    one = mp.run_steps(None, frvsr, device)
    at = meshed[0]["update_params"]
    replay = mp.replay_grads(frvsr, at, device)
    # The one-process step's own change under nudges of the first convs'
    # kernels, at each update's params (as gan_card_vs_cpu bounds).
    own = []
    for i, flat in enumerate(at):
        nudged = mp.replay_grads(frvsr, [mesh_nudge(flat, n)
                                         for n in GAN_NUDGES], device,
                                 updates=[i] * len(GAN_NUDGES))
        own.append(max(mp.rel_l2(g[p], replay[i][p]) for g in nudged
                       for p in g if np.any(replay[i][p])))
    errs = [max(mp.rel_l2(meshed[0]["grads"][i][p], ref)
                for p, ref in replay[i].items()) for i in range(len(at))]
    bounds = [max(TRAIN_GRAD_RTOL, 3 * o) for o in own]
    one_gan = mp.run_steps(None, gan, device)
    if any(k.launches for k in kernels):
        raise AssertionError("mesh: a kernel launched in a train step")
    res = {"frvsr": mp.compare(one, meshed[0], replay),
           "frvsr_free": mp.compare(one, meshed[0]),
           "gan": mp.compare(one_gan, meshed[1]), "spawn_s": spawn_s,
           "launch_s": launch_s, "all_reduce_ms": probed["all_reduce_ms"],
           "all_reduces": meshed[0]["all_reduces"], "grad_errs": errs,
           "own_change": own, "grad_bounds": bounds}
    f, g = res["frvsr"], res["gan"]
    lr = TRAIN_MODELS["frvsr"]["learning_rate"]
    param_bound = 2 * lr * MESH_STEPS + 1e-6
    log(f"mesh frvsr ({len(MESH_DEVICES)} gloo ranks on {MESH_DEVICES[0]}, "
        f"flow 64x10, generator 64x24, global batch {TRAIN_BATCH}, T = "
        f"{TRAIN_T}, crop {TRAIN_CROP}, float32, {MESH_STEPS} steps): loss "
        f"relative error {f['loss_rel']:.2e} (bound {TRAIN_LOSS_RTOL:g}); "
        f"worst gradient relative L2 error {f['grad_rel']:.2e} at "
        f"{f['grad_where']} against the one-process step at the ranks' "
        f"params; by update {[f'{e:.2e}' for e in errs]} against bounds "
        f"{[f'{x:.2e}' for x in bounds]} (the larger of "
        f"{TRAIN_GRAD_RTOL:g} and 3x the one-process step's own largest "
        f"change under {len(GAN_NUDGES)} nudges of the first convs' "
        f"kernels by 1e-7: {[f'{o:.2e}' for o in own]}); "
        f"{res['frvsr_free']['grad_rel']:.2e} against the free-running "
        f"one-process run; params max diff {f['param_max_diff']:.3g} "
        f"(bound {param_bound:.3g}); ranks' params bit-identical: "
        f"{f['ranks_identical']}; step ms one process "
        f"{[round(x, 1) for x in one['step_ms']]}, mesh "
        f"{[round(x, 1) for x in meshed[0]['step_ms']]}")
    log(f"mesh gan (GAN_MODELS damped, float32, 1 step): gate decisions one "
        f"process {g['gates'][0]}, mesh {g['gates'][1]}; EMAs (t_balance1, "
        f"t_balance2) one process {g['emas'][0]}, mesh {g['emas'][1]}; "
        f"gen_loss relative error {g['loss_rel']:.2e} (bound "
        f"{MESH_GEN_LOSS_RTOL:g}); ranks' params bit-identical: "
        f"{g['ranks_identical']}; step ms one process "
        f"{one_gan['step_ms'][0]:.1f}, mesh {meshed[1]['step_ms'][0]:.1f}")
    log(f"mesh ranks: spawn {spawn_s:.1f} s (launch to rank 0's first run), "
        f"launch in all {launch_s:.1f} s; all-reduces a FRVSR step "
        f"{res['all_reduces']}; ms an all-reduce (gloo, float32, by size; "
        f"the tensor on the card or copied through the host): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["all_reduce_ms"].items()))
    if (f["loss_rel"] > TRAIN_LOSS_RTOL
            or any(e > x for e, x in zip(errs, bounds))
            or f["param_max_diff"] > param_bound
            or not f["ranks_identical"] or g["gates"][0] != g["gates"][1]
            or g["loss_rel"] > MESH_GEN_LOSS_RTOL
            or not g["ranks_identical"]):
        raise AssertionError("mesh: the sharded step disagrees with the "
                             "one-process step beyond the bounds")

    res["export_launches"], (engine, frames) = serve_package(
        torch, "mesh export",
        mesh_package("mesh_package", models, meshed[0]["params"], out_dir),
        seed, device)
    engine.reset()
    got = [engine.process(fr) for fr in frames]
    single = create_runtime(
        mesh_package("one_package", models, one["params"], out_dir),
        device=device)
    want = [single.process(fr) for fr in frames]
    res["frames_exact"] = all(np.array_equal(a, b)
                              for a, b in zip(got, want))
    res["frames_max_diff"] = max(
        card_vs_cpu("mesh export", f"frame {i}", a, b,
                    against="the one-process params' package")
        for i, (a, b) in enumerate(zip(got, want)))
    log(f"mesh export: frames bit for bit with the one-process params' "
        f"package {res['frames_exact']} (u8 max {res['frames_max_diff']})")
    res["seconds"] = time.perf_counter() - t0
    log(f"mesh: phase took {res['seconds']:.1f} s")
    return res


DOOR_EXAMPLES = 8  # pair examples written to the TFRecord file
DOOR_BATCHES = 6  # loader batches held against the in-process shards
DOOR_TIMED_BATCHES = 8  # loader batches timed alone, after those
DOOR_ONNX_FRAMES = 4  # each ONNX graph: a clip, a reset(), the clip again
# configs/frvsr_quality.yaml's train_dataset with the TFRecord source and
# the pair parser in place of LocalDatasetOp.
DOOR_CHAIN_TAIL = [
    {"name": "RandomCropOp", "crop_size": TRAIN_CROP, "num_img": 4},
    {"name": "NormalizeOp", "crop_size": TRAIN_CROP},
    {"name": "FilterFlatOp", "threshold": 0.02},
    {"name": "RandomHorizontalFlipOp", "threshold": 0.5},
    {"name": "RandomVerticalFlipOp", "threshold": 0.5},
    {"name": "ClipOp", "minval": -0.5, "maxval": 0.5},
    {"name": "ShuffleOp", "shuffle_window": 64},
    {"name": "RepeatOp"},
]


def door_records(path, n, seed):
    """``n`` pair examples at the capture size, written with the port's
    TFRecord writer: 10 LR 270x480 and 10 HR 1080x1920 frames each,
    PNG-encoded (cv2), smooth patterns moving at a random velocity plus
    noise, the LR the 4x4 mean of the HR.  Returns the file's bytes."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from joshupscale_torch.data.tfrecord import encode_example, write_records

    rng = np.random.default_rng(seed)
    hh, ww = 4 * H, 4 * W
    y, x = np.arange(hh, dtype=np.float32), np.arange(ww, dtype=np.float32)
    noise = rng.integers(-6, 7, (hh, ww, 3)).astype(np.float32)
    png = lambda f: cv2.imencode(".png", f)[1].tobytes()  # noqa: E731
    # numpy and cv2 work outside the interpreter lock: a thread a core.
    pool = ThreadPoolExecutor(os.cpu_count() or 4)

    def frame(t, phase, vy, vx):
        """One HR frame and its LR, PNG-encoded."""
        img = np.stack([np.outer(np.cos((y + vy * t) * 0.013 - p),
                                 np.sin((x + vx * t) * 0.011 + p))
                        for p in phase], -1)
        img = 127.5 + 110 * img + np.roll(noise, 37 * t, axis=1)
        hr = np.clip(img, 0, 255).astype(np.uint8)
        lr = hr.reshape(H, 4, W, 4, 3).mean((1, 3)).astype(np.uint8)
        return png(lr), png(hr)

    def example():
        phase = rng.uniform(0, 2 * np.pi, 3)
        # At least 2 HR pixels a frame each way: FilterFlatOp keeps it.
        vy, vx = rng.choice([-1, 1], 2) * rng.uniform(2, 8, 2)
        pairs = list(pool.map(lambda t: frame(t, phase, vy, vx),
                              range(TRAIN_T)))
        return encode_example({"input": [lr for lr, _ in pairs],
                               "target": [hr for _, hr in pairs]})

    with pool:
        write_records(path, (example() for _ in range(n)))
    return os.path.getsize(path)


def shm_segments():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def door_loader(torch, chain, seed):
    """``create_train_dataset(num_workers=2)`` with the parent holding a
    CUDA context: the first ``DOOR_BATCHES`` batches against the
    in-process ``create_dataset(shard=(2, i))`` streams taken round
    robin (bit for bit), then ``DOOR_TIMED_BATCHES`` batches timed
    alone; closed, it must leave no ``/dev/shm`` segment.  Returns the
    batches/s."""
    import shutil

    from joshupscale_torch.data.pipeline import (
        create_dataset,
        create_train_dataset,
    )

    if not torch.cuda.is_initialized():
        raise AssertionError("doors: the parent holds no CUDA context")
    free = shutil.disk_usage("/dev/shm").free / 2 ** 30
    shards = [iter(create_dataset(
        chain + [{"name": "BatchOp", "batch_size": TRAIN_BATCH}],
        seed=seed, shard=(2, i))) for i in (0, 1)]
    local = [next(shards[i % 2]) for i in range(DOOR_BATCHES)]
    before = shm_segments()
    t0 = time.perf_counter()
    it = iter(create_train_dataset(chain, TRAIN_BATCH, seed=seed,
                                   num_workers=2))
    got = [next(it)]
    first_s = time.perf_counter() - t0
    got += [next(it) for _ in range(DOOR_BATCHES - 1)]
    same = all(np.array_equal(g[k], w[k]) and g[k].dtype == w[k].dtype
               for g, w in zip(got, local) for k in ("input", "target"))
    t1 = time.perf_counter()
    for _ in range(DOOR_TIMED_BATCHES):
        next(it)
    rate = DOOR_TIMED_BATCHES / (time.perf_counter() - t1)
    it.close()
    left = len(shm_segments() - before)
    log(f"doors loader (2 workers, spawn, parent holds a CUDA context; "
        f"/dev/shm {free:.1f} GiB free): first batch after {first_s:.2f} s, "
        f"then {rate:.2f} batches/s of {tuple(got[0]['input'].shape)} -> "
        f"{tuple(got[0]['target'].shape)} float32 alone; first "
        f"{DOOR_BATCHES} batches bit for bit with the in-process shards "
        f"(shard=(2, i), round robin): {same}; /dev/shm segments left "
        f"after close: {left}")
    if not same or left:
        raise AssertionError("doors: the loader's stream or its cleanup "
                             "is wrong")
    return rate


def door_fit(torch, chain, out_dir, workers, seed, device, export):
    """``training.cli.train`` on the TFRecord chain at full width
    (``TRAIN_MODELS``, float32), 2 epochs x 3 steps with checkpoints and
    ``data_workers``; the step time is epoch 1's time over its steps
    (epoch 0 holds the warm-up and the loader's start).  With
    ``export``: weights, the package (270x480, bf16), ``model.onnx``
    and ``model_fp16.onnx``."""
    from joshupscale_torch.training import cli

    models = json.loads(json.dumps(TRAIN_MODELS))
    ckpt = os.path.join(out_dir, f"ckpt_w{workers}")
    config = {"models": models, "train_dataset": chain,
              "train": {"model": "frvsr", "batch_size": TRAIN_BATCH,
                        "epochs": TRAIN_EPOCHS,
                        "steps_per_epoch": TRAIN_STEPS,
                        "data_workers": workers, "checkpoint_dir": ckpt,
                        "tensorboard": False}}
    if export:
        config["export"] = {
            "dir": os.path.join(out_dir, "export"), "model": "inference",
            "onnx": True, "onnx_fp16": True,
            "overrides": {"frame_height": H, "frame_width": W,
                          "compute_dtype": "bfloat16"}}
    t0 = time.perf_counter()
    if cli.train(config, seed=seed, device=device) != 0:
        raise AssertionError("doors: the training CLI failed")
    with open(os.path.join(ckpt, "history.json")) as f:
        history = json.load(f)
    losses = [e["train_loss"] for e in history]
    step_ms = history[-1]["time"] / TRAIN_STEPS * 1e3
    log(f"doors fit (data_workers {workers}): {len(history)} epochs, losses "
        f"{['%.5f' % x for x in losses]}, step {step_ms:.1f} ms (epoch 1 "
        f"over {TRAIN_STEPS} steps), train() took "
        f"{time.perf_counter() - t0:.1f} s")
    if len(history) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError("doors: the fit did not run as expected")
    return {"step_ms": step_ms,
            "checkpoint": os.path.join(ckpt, "latest.npz")}


def door_onnx(torch, name, path, engine, frames, bound=None):
    """``OnnxClipRunner`` over ``path`` with its default executor
    (``run_graph_torch`` on the card), against ``engine`` (float32, the
    same params): the clip, a ``reset()`` of both, the clip again.
    ``bound`` (u8 max) or the card-vs-CPU gate a frame.  Returns the
    worst u8 diff and the runner's ms a frame."""
    from joshupscale_torch.export.onnx_interp import OnnxClipRunner

    runner = OnnxClipRunner(path, H, W)
    worst, times = 0, []
    for rep in range(2):
        runner.reset()
        engine.reset()
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            got = runner.process(f)
            times.append(time.perf_counter() - t0)
            ref = engine.process(f)
            d = int(np.abs(got.astype(np.int32) - ref).max())
            worst = max(worst, d)
            if bound is None:
                card_vs_cpu(name, f"frame {i} (pass {rep})", got, ref,
                            against="Engine float32")
            elif d > bound:
                raise AssertionError(f"{name}: frame {i} (pass {rep}) u8 max "
                                     f"diff {d} > {bound}")
    ms = float(np.median(times[1:])) * 1e3
    log(f"{name}: {len(times)} frames on the card through run_graph_torch "
        f"(a reset() after {len(frames)}) vs Engine float32: worst u8 max "
        f"diff {worst}{'' if bound is None else f' (bound {bound})'}; "
        f"runner {ms:.1f} ms a frame (median, host clock)")
    return worst, ms


def phase_doors(torch, seed, device, out_dir):
    """The doors in and out, at the full width of
    ``configs/frvsr_quality.yaml``: pair examples at the capture size
    written with the port's TFRecord writer; its train chain with the
    TFRecord source through ``MultiprocessLoader`` (2 workers) against
    the in-process shards; ``training.cli.train`` with ``data_workers``
    2 and 0 (step times); the export (package, ``model.onnx``,
    ``model_fp16.onnx``) served through ``create_runtime`` (68 K1 + 1 K2
    a frame, replays bit for bit); ``load_trained_params`` on the fit's
    checkpoint served bit for bit with the package; the ONNX graphs on
    the card through ``run_graph_torch`` against the float32 ``Engine``
    (f32 within u8 max 1; fp16 and an int8 QDQ graph from ``calibrate``
    on the card within the card-vs-CPU gate).  The h5 door is not
    driven: the card run does not depend on h5py (the CPU tests hold
    it)."""
    from joshupscale_torch.export.importer import load_trained_params
    from joshupscale_torch.export.onnx_export import export_onnx
    from joshupscale_torch.export.package import load_package
    from joshupscale_torch.export.quantize import calibrate
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import Engine, WARMUP_STEPS

    t0 = time.perf_counter()
    out_dir = os.path.join(out_dir, "doors")
    os.makedirs(out_dir, exist_ok=True)
    records = os.path.join(out_dir, "pairs.tfrecords")
    size = door_records(records, DOOR_EXAMPLES, seed)
    log(f"doors records: {DOOR_EXAMPLES} pair examples of {TRAIN_T} LR "
        f"{H}x{W} + {TRAIN_T} HR {4 * H}x{4 * W} PNG frames, "
        f"{size / 2 ** 20:.1f} MiB, written in "
        f"{time.perf_counter() - t0:.1f} s")
    chain = [{"name": "TFRecordDatasetOp", "path": records},
             {"name": "ParsePairExampleOp"}] + DOOR_CHAIN_TAIL
    res = {"loader_batches_per_s": door_loader(torch, chain, seed)}
    res["fit"] = door_fit(torch, chain, out_dir, 2, seed, device,
                          export=True)
    res["fit_workers0"] = door_fit(torch, chain, out_dir, 0, seed, device,
                                   export=False)
    log(f"doors fit step: data_workers 2 {res['fit']['step_ms']:.1f} ms vs "
        f"data_workers 0 {res['fit_workers0']['step_ms']:.1f} ms")

    export = os.path.join(out_dir, "export")
    res["export_launches"], res["engine"] = serve_package(
        torch, "doors export", os.path.join(export, "package"), seed, device)
    engine, frames = res["engine"]

    # load_trained_params on the fit's checkpoint (the params. prefix).
    model, template = load_package(os.path.join(export, "package"))
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    loaded = Engine(model, load_trained_params(res["fit"]["checkpoint"],
                                               template), device=device)
    engine.reset()
    same = all(np.array_equal(loaded.process(f), engine.process(f))
               for f in frames)
    torch.cuda.synchronize()
    k1, k2 = kernels[0].launches, kernels[1].launches
    res["loaded_launches"] = (k1, k2)
    log(f"doors load_trained_params (prefix 'params' of the fit's "
        f"latest.npz) through Engine: {len(frames)} frames bit for bit with "
        f"the package's: {same}; K1 {k1}, K2 {k2} "
        f"({(k1 / (WARMUP_STEPS + 1)):g} + {k2 / (WARMUP_STEPS + 1):g} a "
        f"step)")
    if not same or (k1, k2) != (K1_PER_FRAME * (WARMUP_STEPS + 1),
                                WARMUP_STEPS + 1):
        raise AssertionError("doors: load_trained_params does not serve the "
                             "package's frames")
    del loaded

    # The ONNX graphs against the float32 engine of the same params.
    f32_cfg = json.loads(json.dumps(TRAIN_MODELS))
    f32_cfg["inference"].update(skip_processing=False, frame_height=H,
                                frame_width=W, compute_dtype="float32")
    f32 = create_models(f32_cfg, seed=0)["inference"]
    params = load_trained_params(res["fit"]["checkpoint"], f32.params)
    ref = Engine(f32.obj, params, device=device)
    clip = frames[:DOOR_ONNX_FRAMES]
    res["onnx_f32"] = door_onnx(torch, "doors onnx f32",
                                os.path.join(export, "model.onnx"), ref,
                                clip, bound=1)
    res["onnx_fp16"] = door_onnx(torch, "doors onnx fp16",
                                 os.path.join(export, "model_fp16.onnx"),
                                 ref, clip)
    ranges = calibrate(f32.obj, params, frames[:DOOR_ONNX_FRAMES, None],
                       device=device)
    int8_path = os.path.join(out_dir, "model_int8.onnx")
    export_onnx(int8_path, params, H, W, int8_ranges=ranges)
    res["onnx_int8"] = door_onnx(torch, f"doors onnx int8 QDQ ({len(ranges)} "
                                 f"convs calibrated on the card)", int8_path,
                                 ref, clip)
    log("doors h5: not driven on the card (the card run does not depend on "
        "h5py); tests/test_torch_importer.py holds the door on the CPU")
    res["seconds"] = time.perf_counter() - t0
    log(f"doors: phase took {res['seconds']:.1f} s")
    return res


def to_cpu(torch, tree):
    if isinstance(tree, dict):
        return {k: to_cpu(torch, v) for k, v in tree.items()}
    return tree.detach().cpu()


def phase_conv_probe(torch, device, k1_conv_ms, conv_ms):
    """The second path: the conv probe tool's run over every variant
    (each held against its plain version at full shape, then timed), its
    kernel launches counted; then K1 against its parts, and P2's pair
    against K1's two launches of a res block (``k1_conv_ms``: conv_1's
    and conv_2's times, this run)."""
    from joshupscale_torch.tools import conv_probe

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    res = conv_probe.run(conv_probe.VARIANTS, conv_probe.DOT_TILE, device,
                         log=log)
    torch.cuda.synchronize()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    log(f"conv_probe path: P1 launches={p1}, P2 launches={p2}, K1/K2 "
        f"launches={k1}/{k2}")
    if not p1 or not p2 or k1 or k2:
        raise AssertionError("the conv probe path must launch P1 and P2 "
                             "and no serving kernel")
    us = lambda name: res[name]["ms"] * 1e3  # noqa: E731
    c1, c2 = (ms * 1e3 for ms in k1_conv_ms)
    log(f"K1 and its parts at (1, {H}, {W}, 64) bf16, this run: K1 conv_1 "
        f"{c1:.2f} us | P2 patch {us('patch'):.2f} us | P1 "
        f"dot64_resident {us('dot64_resident'):.2f} us | cuDNN conv+relu "
        f"{us('cudnn'):.2f} us (conv alone, K1's weights: "
        f"{conv_ms * 1e3:.2f} us)")
    log(f"res block, this run: P2 pair (both convs, relu, residual add in "
        f"one launch, y1 kept on chip) {us('pair'):.2f} us vs K1 conv_1 + "
        f"conv_2 (two launches) {c1:.2f} + {c2:.2f} = {c1 + c2:.2f} us: "
        f"pair / K1 pair = {us('pair') / (c1 + c2):.3f}")
    return res, p1, p2


def probe_entry(name, source, replaces, variants, res, launches):
    """The kernel line's entry for P1 or P2: the first variant's numbers
    at top level, each other variant's under "other_variants"."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "max_abs_err", "share_of_bf16_peak",
            "fraction_of_bound")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "path": "conv_probe",
        "serving_launches_per_frame": 0, "variant": variants[0],
        **{k: res[variants[0]][k] for k in keys},
        "other_variants": {v: {k: res[v][k] for k in keys}
                           for v in variants[1:]},
    }


def profile(torch, name, engine, frames, device, out_dir):
    """A serving path's replayed frame graphs (step and display) under
    ``torch.profiler``: device ops and busy time a frame, the idle share
    of the span, the device time by part; the table and trace go to
    ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    prof, events, _ = replay_kernels(
        torch, engine, dev_frame,
        trace_path=os.path.join(out_dir, f"trace_step_{name}.json"))
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"profile_step_{name}.txt"), "w") as f:
        f.write(table)
    events.sort(key=lambda e: e["ts"])
    busy, cur_start, cur_end = 0.0, None, None
    for e in events:  # union of device intervals
        s, t = e["ts"], e["ts"] + e["dur"]
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, t
        else:
            cur_end = max(cur_end, t)
    busy += cur_end - cur_start
    span = max(e["ts"] + e["dur"] for e in events) - events[0]["ts"]
    groups = {}
    for e in events:
        key = kernel_group(e["name"])
        groups[key] = groups.get(key, 0.0) + e["dur"]
    log(f"{name} profile of 3 replayed frames: {len(events) / 3:.0f} device "
        f"ops/frame, device busy {busy / 3e3:.3f} ms/frame of a "
        f"{span / 3e3:.3f} ms/frame span (idle share "
        f"{1 - busy / span:.3f}, profiler on)")
    for key, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {key}: {us / 3e3:.3f} ms/frame")
    log(f"profile written to {out_dir}")


SPATIAL_FRAMES = 6  # each spatial path: frames held against Engine
SPATIAL_TIMED = 13  # process a frame, spatial and Engine in turns
SPATIAL_PATHS = (("quality", 2), ("quality", 4), ("ps2_style", 2))


def spatial_first_diff(torch, model, params, device, slabs, frames, upto):
    """The first layer whose output differs between the whole frame (a
    1-slab ``SpatialEngine``) and ``slabs`` slabs, on frame ``upto``
    after the frames before it: (name, max abs diff) or None."""
    from joshupscale_torch.parallel import SpatialEngine

    whole = SpatialEngine(model, params, devices=[device])
    split = SpatialEngine(model, params, devices=[device] * slabs)
    for i in range(upto + 1):
        if i == upto:
            whole.taps, split.taps = {}, {}
        whole.process(frames[i])
        split.process(frames[i])
    for name, a in whole.taps.items():
        b = split.taps[name]
        if not torch.equal(a, b):
            return name, float((a.float() - b.float()).abs().max())
    return None


def phase_spatial(torch, seed, device):
    """``SpatialEngine`` (one stream's frame split by LR rows, K1 on
    slab plus halo) at full width on one card: quality on 2 and 4 slabs
    and ``ps2_style`` on 2, each slab on ``cuda:0``.  The launch counts
    set to 0, ``SPATIAL_FRAMES`` frames and a frame after ``reset()``
    through ``process``, held against ``Engine.process`` (its replayed
    graph) on the same frames: bit for bit, else the first layer that
    differs (against the whole frame on the same code) is printed and
    the frames must stay within u8 max 1.  K1 and K2 launches a frame
    are checked (K1: the whole frame's count per slab; K2: one per
    slab).  Then ``process`` is timed beside ``Engine.process`` on the
    same frames, in turns: one card shows no latency gain."""
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.parallel import SpatialEngine
    from joshupscale_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    kernels = all_kernels()
    res = {}
    frames = frames_for(SPATIAL_TIMED, seed)
    for tier in dict(SPATIAL_PATHS):
        config = quality_config() if tier == "quality" else ps2_config(tier)
        built = create_models(config, seed=seed)["inference"]
        params = seeded_params(torch, built, seed)
        engine = Engine(built.obj, params, device=device)
        want = [engine.process(f) for f in frames[:SPATIAL_FRAMES]]
        k1_whole = 2 * (24 if tier == "quality" else PS2_LADDERS[tier][2])
        if tier == "quality":
            k1_whole += 2 * 10
        for t, slabs in SPATIAL_PATHS:
            if t != tier:
                continue
            name = f"spatial {tier} x{slabs}"
            spatial = SpatialEngine(built.obj, params,
                                    devices=[device] * slabs)
            for k in kernels:
                k.launches = 0
            got = [spatial.process(f) for f in frames[:SPATIAL_FRAMES]]
            spatial.reset()
            got.append(spatial.process(frames[0]))
            torch.cuda.synchronize()
            k1, k2, p1, p2 = (k.launches for k in kernels)
            n = len(got)
            log(f"{name}: rows {spatial.split.bounds} (flow net "
                f"{getattr(spatial, 'flow_split', spatial.split).bounds}); "
                f"{n} frames through process: K1 launches={k1} "
                f"({k1 / n:g}/frame), K2 launches={k2} ({k2 / n:g}/frame), "
                f"P1/P2 launches={p1}/{p2}")
            if (k1 != k1_whole * slabs * n or k2 != slabs * n or p1 or p2):
                raise AssertionError(
                    f"{name}: expected {k1_whole * slabs} K1 and {slabs} K2 "
                    f"a frame, no P1/P2; got {k1 / n:g}, {k2 / n:g}, {p1}, "
                    f"{p2}")
            diffs = [int(np.abs(g.astype(np.int32)
                                - w.astype(np.int32)).max())
                     for g, w in zip(got, want + want[:1])]
            exact = not any(diffs)
            first = None
            if not exact:
                upto = next(i for i, d in enumerate(diffs) if d)
                first = spatial_first_diff(
                    torch, built.obj, params, device, slabs, frames,
                    min(upto, SPATIAL_FRAMES - 1))
            log(f"{name} vs Engine.process (its replayed graph), "
                f"{SPATIAL_FRAMES} frames and 1 after reset(): bit for bit "
                f"{exact}; u8 max diff per frame {diffs}"
                + ("" if exact else f"; first layer that differs from the "
                   f"whole frame: {first}"))
            if max(diffs) > 1:
                raise AssertionError(f"{name}: frames differ from Engine "
                                     f"by more than 1")
            sp_ms, en_ms = [], []
            for f in frames:
                t1 = time.perf_counter()
                spatial.process(f)
                t2 = time.perf_counter()
                engine.process(f)
                sp_ms.append((t2 - t1) * 1e3)
                en_ms.append((time.perf_counter() - t2) * 1e3)
            sp, en = float(np.median(sp_ms[3:])), float(np.median(en_ms[3:]))
            log(f"{name}: process median {sp:.3f} ms/frame (eager, "
                f"{slabs} slabs on one card) beside Engine.process "
                f"{en:.3f} ms (replayed graph), same frames in turns; one "
                f"card cannot show a latency gain")
            res[name] = {"k1": k1 // n, "k2": k2 // n, "exact": exact,
                         "max_diff": max(diffs), "first_diff": first,
                         "ms": sp, "engine_ms": en,
                         "rows": list(spatial.split.bounds)}
            del spatial
        del engine
    log(f"spatial: phase took {time.perf_counter() - t0:.1f} s")
    return res


def profile_fit(torch, seed, device, out_dir):
    """``fit``'s profiler window on the card: the full-width FRVSR
    config (``train_config``) for 4 steps with ``profile_dir`` and a
    window of global steps 1..2; the trace it writes must hold CUDA
    kernel events.  Returns (kernel events, trace files)."""
    import glob
    import itertools

    from joshupscale_torch.training.cli import build_training
    from joshupscale_torch.training.trainer import fit

    config = train_config(out_dir, "bfloat16")
    setup = build_training(config, seed, device)
    prof_dir = os.path.join(out_dir, "profile")
    fit(setup.step, setup.state, itertools.cycle(train_batches(2, seed)),
        epochs=1, steps_per_epoch=4,
        rng=torch.Generator(device).manual_seed(seed), log_fn=lambda s: None,
        profile_dir=prof_dir, profile_batch=(1, 2))
    torch.cuda.synchronize()
    files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    kernels = 0
    for path in files:
        with open(path) as f:
            kernels += sum(1 for e in json.load(f)["traceEvents"]
                           if e.get("ph") == "X" and e.get("cat") == "kernel")
    log(f"fit profiler window (global steps 1..2 of 4, flow 64x10, "
        f"generator 64x24, bf16): {len(files)} trace file(s) in "
        f"profile_dir, {kernels} CUDA kernel events")
    if len(files) != 1 or not kernels:
        raise AssertionError("fit's profiler window traced no CUDA kernel")
    return kernels, len(files)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None)
    args = ap.parse_args()

    os.environ.update(CUPTI_ENV)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 1
    from joshupscale_torch import resolve_device
    from joshupscale_torch.kernels import _build
    from joshupscale_torch.tools.timing import card_line

    started = time.perf_counter()
    device = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build (nvcc, sm_90a, in parallel): "
        f"{time.perf_counter() - t0:.1f} s")
    usage = _build.resource_usage()
    for source, rows in usage.items():
        log(f"ptxas -v {source}.cu: " + "; ".join(
            f"{k} {r} registers, {sp} B spilled"
            + (f", {len(n)} notes ({n[0].split()[0]})" if n else "")
            for k, r, sp, n in rows))
    if any(sp for _, _, sp, _ in usage["probe_patch_dot"]):
        raise AssertionError("P2 spills registers")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.default_rng(args.seed)
    k1_err = phase_k1(torch, rng, device)
    k2_err = phase_k2(torch, rng, device)
    # Every host-clock timing runs before the first torch.profiler
    # session of the process; the engines stay alive until the profiler
    # phases.
    paths = {}
    engine, frames, k1_launches, k2_launches, built = drive_path(
        torch, "quality", quality_config(), args.seed, device, K1_PER_FRAME,
        1)
    paths["quality"] = (engine, frames, K1_PER_FRAME, 1)
    times = phase_times(torch, engine, frames, device)
    runtime = phase_runtime(torch, quality_config(), engine, built, frames,
                            device, times["k2"][0])
    del engine, built
    ps2 = phase_ps2(torch, args.seed, device, paths)
    variants = phase_variants(torch, args.seed, device, paths)
    int8 = phase_int8(torch, args.seed, device, paths)
    batched = {}
    par = phase_parallel(torch, args.seed, device, batched)
    spatial = phase_spatial(torch, args.seed, device)
    k1_n2, lib_n2 = time_k1(torch, device, 64, n=2)
    with tempfile.TemporaryDirectory() as train_dir:
        train = phase_train(torch, args.seed, device, train_dir)
        gan = phase_gan(torch, args.seed, device, train_dir)
        doors = phase_doors(torch, args.seed, device, train_dir)
        mesh = phase_mesh(torch, args.seed, device, train_dir)
    paths["trained export"] = (*train.pop("engine"), K1_PER_FRAME, 1)
    paths["gan export"] = (*gan.pop("engine"), K1_PER_FRAME, 1)
    paths["doors export"] = (*doors.pop("engine"), K1_PER_FRAME, 1)
    probes, p1_launches, p2_launches = phase_conv_probe(
        torch, device, (times["k1"]["conv_1"][0], times["k1"]["conv_2"][0]),
        times["lib_ms"])
    after = phase_profiled(torch, paths, ps2, device, args.profile, batched)
    train_prof = profile_train(
        torch, args.seed, device,
        {d: train[d]["step_ms"] for d in ("float32", "bfloat16")})
    gan_prof = profile_train(
        torch, args.seed, device,
        {d: gan[d]["step_ms"] for d in ("float32", "bfloat16")}, "gan",
        lambda dtype: build_gan(torch, gan_config("unused", dtype),
                                args.seed, device))
    with tempfile.TemporaryDirectory() as fit_dir:
        fit_kernels, _ = profile_fit(torch, args.seed, device, fit_dir)
    paths.clear()
    batched.clear()

    (c1, p1, b1, by1), (c2, p2, b2, by2) = (times["k1"]["conv_1"],
                                            times["k1"]["conv_2"])
    k2_ms, k2_plain, k2_bound = times["k2"]
    k1_ms = (c1 + c2) / 2
    (d1, q1, e1, _), (d2, q2, e2, ey2) = (ps2["k1_c48"]["conv_1"],
                                          ps2["k1_c48"]["conv_2"])
    by_path = {"quality": (k1_launches, k2_launches),
               **{t: (ps2[t]["k1"], ps2[t]["k2"])
                  for t in ("ps2_style", "ps2_fast")},
               **{f"variant {v}": (n["K1"], n["K2"])
                  for v, n in variants.items()},
               **{name: (int8[name]["k1"], int8[name]["k2"])
                  for name in ("int8 quality", "int8 quality calibrated",
                               "int8 ps2_style")},
               **{name: (par[name]["k1"], par[name]["k2"])
                  for name in ("sharded x2", "sharded x4", "pipelined")},
               "trained export": train["export_launches"],
               "gan export": gan["export_launches"],
               "doors export": doors["export_launches"],
               "doors load_trained_params": doors["loaded_launches"],
               "mesh export": mesh["export_launches"],
               "gan play (one prediction, f32)": (gan["play_k1"], 0),
               **{name: (spatial[name]["k1"], spatial[name]["k2"])
                  for name in spatial}}
    (n1, nq1, nb1, _), (n2, nq2, nb2, nby2) = (k1_n2["conv_1"],
                                               k1_n2["conv_2"])
    kernels = [
        {"name": "resblock_conv3x3", "route": "cuda",
         "source": "joshupscale_torch/csrc/resblock_conv.cu",
         "replaces": "joshupscale_tpu/nn/resblock_pallas.py:84",
         "launches": k1_launches, "path": "serving",
         "max_abs_err": k1_err[64],
         "ms": k1_ms, "plain_ms": (p1 + p2) / 2,
         "bound_ms": (b1 + b2) / 2,
         "bound_by": by2 if b2 >= b1 else by1,
         "library_ms": times["lib_ms"],
         "share_of_bf16_peak":
             k1_flops(1, H, W, 64) / (k1_ms * 1e-3) / PEAK_BF16_FLOPS,
         "fraction_of_bound": (b1 + b2) / 2 / k1_ms,
         "launches_by_path": {k: v[0] for k, v in by_path.items()},
         "c48": {"ms": (d1 + d2) / 2, "conv_1_ms": d1, "conv_2_ms": d2,
                 "plain_ms": (q1 + q2) / 2, "bound_ms": (e1 + e2) / 2,
                 "bound_by": ey2, "library_ms": ps2["lib_ms_c48"],
                 "max_abs_err": k1_err[48],
                 "share_of_bf16_peak": k1_flops(1, H, W, 48)
                 / ((d1 + d2) / 2 * 1e-3) / PEAK_BF16_FLOPS},
         "n2": {"shape": [2, H, W, 64], "ms": (n1 + n2) / 2,
                "conv_1_ms": n1, "conv_2_ms": n2, "plain_ms": (nq1 + nq2) / 2,
                "bound_ms": (nb1 + nb2) / 2, "bound_by": nby2,
                "library_ms": lib_n2, "max_abs_err": k1_err["n2"],
                "fraction_of_bound": (nb1 + nb2) / (n1 + n2)},
         "n4": {"shape": [4, H, W, 64], "max_abs_err": k1_err["n4"]}},
        {"name": "d2s_display_u8", "route": "cuda",
         "source": "joshupscale_torch/csrc/display_u8.cu",
         "replaces": "joshupscale_tpu/ops/display.py:35",
         "launches": k2_launches, "path": "serving", "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": None,
         "launches_by_path": {k: v[1] for k, v in by_path.items()}},
        probe_entry("probe_dot", "joshupscale_torch/csrc/probe_dot.cu",
                    "tools/pallas_conv_probe.py:61",
                    ["dot64_resident", "dot128_resident", "dot64_stream"],
                    probes, p1_launches),
        probe_entry("probe_patch_dot",
                    "joshupscale_torch/csrc/probe_patch_dot.cu",
                    "tools/pallas_conv_probe.py:120", ["patch", "pair"],
                    probes, p2_launches),
    ]
    for tier, t in (("quality", times), ("ps2_style", ps2["ps2_style"]),
                    ("ps2_fast", ps2["ps2_fast"])):
        log(f"{tier}: Engine.process median {t['frame_ms']:.3f} ms, p80 "
            f"{t['frame_p80_ms']:.3f} ms; step + display eager "
            f"{t['eager_ms'][0]:.3f} / {t['eager_ms'][1]:.3f} ms, replayed "
            f"{t['replayed_ms'][0]:.3f} / {t['replayed_ms'][1]:.3f} ms, "
            f"device only {t['eager_device_ms']:.3f} / "
            f"{t['replayed_device_ms']:.3f} ms on {card}")
    for name, t in int8.items():
        if name == "calibration":
            continue
        log(f"{name}: Engine.process median {t['frame_ms']:.3f} ms, p80 "
            f"{t['frame_p80_ms']:.3f} ms; step + display eager "
            f"{t['eager_ms'][0]:.3f} / {t['eager_ms'][1]:.3f} ms, replayed "
            f"{t['replayed_ms'][0]:.3f} / {t['replayed_ms'][1]:.3f} ms; vs "
            f"bf16: u8 mean diff {t['vs_float']['u8_mean_diff']:.4f}, PSNR "
            f"{t['vs_float']['psnr_db']:.2f} dB on {card}")
    log(f"parallel: single-stream process {par['single']['fps']:.1f} "
        f"frames/s; " + "; ".join(
            f"{name} {par[name]['fps_total']:.1f} in all, "
            f"{par[name]['fps_per_stream']:.1f} per stream (replayed step "
            f"{par[name]['step_ms']:.3f} ms; streams bit for bit with the "
            f"single-stream Engine: {par[name]['streams_exact']}, u8 max "
            f"diff {par[name]['max_diff_vs_single']})"
            for name in ("sharded x2", "sharded x4"))
        + f"; pipelined process {par['pipelined']['ms'][0]:.3f} / "
        f"{par['pipelined']['ms'][1]:.3f} ms (Engine "
        f"{par['pipelined']['engine_ms'][0]:.3f} / "
        f"{par['pipelined']['engine_ms'][1]:.3f}), async "
        f"{par['pipelined']['async_fps']:.1f} (Engine "
        f"{par['pipelined']['engine_async_fps']:.1f}) frames/s on {card}")
    for name, t in spatial.items():
        log(f"{name}: frames bit for bit with Engine {t['exact']} (u8 max "
            f"{t['max_diff']}), {t['k1']} K1 + {t['k2']} K2 a frame, process "
            f"{t['ms']:.3f} ms beside Engine.process {t['engine_ms']:.3f} ms "
            f"(one card: no latency gain can show) on {card}")
    log(f"fit profiler window: {fit_kernels} CUDA kernel events traced "
        f"over 2 full-width bf16 FRVSR steps on {card}")
    log(f"quality after the profiler sessions: step + display eager "
        f"{after['eager_ms'][0]:.3f} / {after['eager_ms'][1]:.3f} ms, "
        f"replayed {after['replayed_ms'][0]:.3f} / "
        f"{after['replayed_ms'][1]:.3f} ms on {card}")
    split, fps = runtime["split"], runtime["async_fps"]
    log(f"quality runtime: process {split['process']:.3f} ms = step "
        f"{split['step']:.3f} + input copy {split['input']:.3f} + display "
        f"{split['display']:.3f} + u8 copy {split['u8']:.3f} + rest "
        f"{split['rest']:.3f}; process_async "
        + ", ".join(f"{v:.1f}" for v in fps.values())
        + f" frames/s at max_inflight 1, 2, 3; benchmark scan_diff "
        f"{runtime['scan_diff']['frame_ms']:.3f} ms/frame, per_dispatch "
        f"p50 {runtime['per_dispatch']['p50'] * 1e3:.3f} ms on {card}")
    for dtype in ("float32", "bfloat16"):
        t = train[dtype]
        log(f"train {dtype} (flow 64x10, generator 64x24, batch "
            f"{TRAIN_BATCH}, T = {TRAIN_T}, crop {TRAIN_CROP}): optimizer "
            f"step median {t['step_ms']:.2f} ms (spread "
            f"{t['step_spread_ms'][0]:.2f}-{t['step_spread_ms'][1]:.2f}), "
            f"forward {t['forward_ms']:.2f} + backward {t['backward_ms']:.2f}"
            f" + optimizer {t['optimizer_ms']:.2f} ms, peak memory "
            f"{t['peak_gib']:.2f} GiB, {t['syncs_per_step']} synchronising "
            f"calls a step, device busy {train_prof[dtype]['busy_ms']:.2f} "
            f"ms (idle share {train_prof[dtype]['idle_share']:.3f}) on "
            f"{card}")
    for dtype in ("float32", "bfloat16"):
        t, p = gan[dtype], gan_prof[dtype]
        log(f"gan {dtype} (flow 64x10, generator 64x24, discriminator "
            f"alpha 0.25, VGG19, batch {TRAIN_BATCH}, T = {TRAIN_T}, crop "
            f"{TRAIN_CROP}): step median {t['step_ms']:.2f} ms (spread "
            f"{t['step_spread_ms'][0]:.2f}-{t['step_spread_ms'][1]:.2f}), "
            f"forward {t['forward_ms']:.2f} + backward {t['backward_ms']:.2f}"
            f" + optimizer {t['optimizer_ms']:.2f} ms, peak memory "
            f"{t['peak_gib']:.2f} GiB, {t['syncs_per_step']} synchronising "
            f"calls a step, {p['ops']:.0f} device ops, device busy "
            f"{p['busy_ms']:.2f} ms (idle share {p['idle_share']:.3f}), "
            f"discriminator trained {t['discr_steps']} of {t['steps']} "
            f"steps on {card}")
    fit2, fit0 = doors["fit"], doors["fit_workers0"]
    log(f"doors (flow 64x10, generator 64x24, batch {TRAIN_BATCH}, T = "
        f"{TRAIN_T}, crop {TRAIN_CROP}, TFRecords of PNG frames): loader "
        f"{doors['loader_batches_per_s']:.2f} batches/s alone (2 "
        f"workers); fit step {fit2['step_ms']:.1f} ms with data_workers 2, "
        f"{fit0['step_ms']:.1f} ms with 0; ONNX on the card vs Engine "
        f"float32: f32 max {doors['onnx_f32'][0]}, fp16 max "
        f"{doors['onnx_fp16'][0]}, int8 QDQ max {doors['onnx_int8'][0]}; "
        f"runner {doors['onnx_f32'][1]:.1f} ms a frame (f32); phase "
        f"{doors['seconds']:.1f} s on {card}")
    f, g = mesh["frvsr"], mesh["gan"]
    log(f"mesh (2 gloo ranks on one card, full-width FRVSR float32, global "
        f"batch {TRAIN_BATCH}): loss rel {f['loss_rel']:.2e}, worst "
        f"gradient rel {f['grad_rel']:.2e}, ranks bit-identical "
        f"{f['ranks_identical']}, step median one process "
        f"{f['step_ms'][0]:.1f} ms, mesh {f['step_ms'][1]:.1f} ms; GAN "
        f"gates {g['gates'][1]} (one process {g['gates'][0]}), gen_loss "
        f"rel {g['loss_rel']:.2e}, step {g['step_ms'][0]:.1f} / "
        f"{g['step_ms'][1]:.1f} ms; served 68 K1 + 1 K2 a step, u8 max "
        f"{mesh['frames_max_diff']} against the one-process params; spawn "
        f"{mesh['spawn_s']:.1f} s; phase {mesh['seconds']:.1f} s on {card}")
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
