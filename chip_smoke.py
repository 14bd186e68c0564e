#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile DIR]

Builds the port's CUDA kernels from ``joshupscale_torch/csrc`` and
prints each kernel's registers and spills (``ptxas -v``), holds K1 (C =
32, 48, 64; full frame at each, and at N = 2 and 4) and K2 (full
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
with scales from ``calibrate`` (run on the card; card and CPU range
maps compared on the architecture cut to 2 res blocks a net) and on
``ps2_style``, timed, and held against the
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
(68 K1 + 1 K2 a step), checked as the serving paths are.  The
lifecycle phase (``phase_lifecycle``) follows the GAN phase: the
model-quality tools of ``joshupscale_torch/tools/`` in this process
(a synthetic set rendered from ``docs/learned_compare.png``,
``bn_recalibrate`` on the FRVSR phase's checkpoint, ``eval_synth`` three
ways and on the CPU, ``eval_serving_fullres`` at 270x480, ``drift_1000``
at T = 1000 with its launches counted and stream against clip 0, a
6-step full-width ``gan_soak``).  The doors
phase (``phase_doors``) follows: pair examples at the
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
package).  Then the conv probe and the replayed graphs' kernel counts
(below) run, and the native phase (``phase_native``) follows: the C++ host
over the port (``joshupscale_torch/native``) built; the OBS model set
written by ``python -m joshupscale_torch.tools.make_model_set`` at full
width with each tier's ``step.pt2`` compiled on the card (two processes
side by side, each exporting two tiers in turn; ``model_psp_fast`` from
a ``--weights`` npz whose flow head makes 4 px flows); each tier's
artifact counted in its trace (68 / 36 / 48 / 24 K1 + 1 K2 by kernel
name), its frames and float state held to ``Engine``'s, and served
through ``upscale_cli`` with the Python-free backend within the
card-vs-CPU gate; two more processes beside them write the int8 tiers
of the int8 phase (quality with dynamic and with calibrated scales in
one, ``ps2_style`` in the other) as ``step.pt2`` sets for the card,
each checked the same way (0 K1 + 1 K2 in the trace, its graph's
``aten._int_mm`` nodes equal to its quantized convs, against the int8
``Engine``).  While any export runs, only untimed checks run here
(the artifacts against ``Engine``, the fake OBS host, the installed
host; the host builds beside the exports); the traces and the
timings come after the last export has ended.  The
fake OBS host over the set (the psp -> ps2 swap, the masked HUD
compose, a missing model and the recovery) against ``Engine``; the host
installed (``cmake --install``) and its ``upscale_cli`` run with the
build trees moved away; the embedded-Python backend's refusal of an
int8 package; on the quality tier the embedded-Python backend (bit for
bit with ``Engine.process``, synchronous and pipelined; not timed
here); on the quality tier and on ``int8 quality`` the Python-free one,
synchronous and pipelined, with ms a frame taken from outside the
process (``tools/run_native.py``: the frames fed through a FIFO and
stamped as the CLI takes them), each held to be at least the artifact's
device time (CUDA events without the profiler, and the trace's busy
time).  The tools
phase (``phase_tools``, after the GAN phase) runs the measurement tools
no other phase runs: ``latency_probe`` over 200 quality frames (device
and ``Engine.process`` p50 / p90 / p99), ``serving_check``,
``gather_relayout_probe`` at 270x480 and, on the GAN phase's bf16
setup, ``fit_cost_probe`` A, B and G, ``fit_overlap_bench``'s lag 0 and
1 and ``train_step_bench``'s timed rounds; ``pipeline_probe`` times
``PipelinedEngine``'s two stage graphs in the parallel phase.  The
conv probe (``joshupscale_torch.tools.conv_probe.run``)
holds P1 and P2 against their plain versions at full shape (all five
variants) and times them, checks that it went through P1 and P2, and
prints K1, P2, P1 and cuDNN side by side at the res-block conv's
shape, and P2's fused pair (a whole res block in one launch) beside
K1's two launches.  The phases under ``torch.profiler`` come after
every host-clock timing of this process (a profiler session can leave
the host launching more slowly; the quality step is timed once more
after them, labelled): each path's replays counted by kernel and the
PS2 steps' device time split by stage and kernel (before the native
phase), the training steps' device time (the setups the training
phases timed, kept warm) and ``fit``'s profiler window
(``profile_fit``: 4 bf16 FRVSR steps of the timed setup, steps 1..2
traced; the trace must hold CUDA kernel events, and gives the bf16
FRVSR step's split); after the native
phase one more session of the quality graph's replays is logged,
informational (``recount_after_native``).  The end of each group of
phases is logged with the script's elapsed time.  K1's and the
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
    quality and PS2-style generators), 48 (PS2-fast), 32 (the fast
    tier's flow net) and C = 64 at N = 2
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
             ((1, H, W), 32, bf16),
             ((2, H, W), 64, bf16), ((4, H, W), 64, bf16),
             ((2, 19, 37), 32, bf16),
             ((2, 19, 37), 48, bf16), ((1, 45, 80), 64, f32),
             ((2, 19, 37), 32, f32)]
    worst_main = {64: 0.0, 48: 0.0, 32: 0.0, "n2": 0.0, "n4": 0.0}
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


# A CPU reference that repeats what the tests hold against the JAX
# package (calibrate's range map, VideoStream's seeks, the serving
# options' and the int8 tiers' frames) runs on its architecture cut to
# this many res blocks a net (``cut_depth``): at full depth the CPU side
# took 18-31 s each for the first two on an H100's host, 4.5-6.5 s a
# frame for an int8 tier.
CPU_CHECK_BLOCKS = 2


def cut_depth(config: dict, blocks: int = None) -> dict:
    """``config`` with its resnets cut to ``blocks`` (default
    ``CPU_CHECK_BLOCKS``) res blocks: the same layer kinds at the same
    shapes (an autoencoder flow net has no res blocks and stays)."""
    blocks = blocks or CPU_CHECK_BLOCKS
    config = json.loads(json.dumps(config))
    for entry in config.values():
        if "num_res_blocks" in entry:
            entry["num_res_blocks"] = min(entry["num_res_blocks"], blocks)
    return config


def cut_quality(torch, seed):
    """The quality tier's entry cut to ``CPU_CHECK_BLOCKS`` res blocks a
    net, with seeded params: ``(built, params)``."""
    from joshupscale_torch.models.registry import create_models

    built = create_models(cut_depth(quality_config()), seed=seed)["inference"]
    return built, seeded_params(built, seed)


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
    it recorded at capture (``counted_session``)."""
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    expected = (k1_per_frame, k2_per_frame)
    last = {}

    def count():
        _, last["events"], per = replay_kernels(engine, dev_frame)
        return per

    per, _ = counted_session(name, count, expected, log)
    log(f"{name}: profiled replays run {per[0]:g} K1 and {per[1]:g} K2 "
        f"kernels each")
    if per != expected:
        groups = [kernel_group(e["name"]) for e in last["events"]]
        log(f"{name}: the last session's {len(groups)} device events by "
            f"part: " + ", ".join(f"{g} {groups.count(g)}"
                                  for g in sorted(set(groups))))
        raise AssertionError(f"{name}: a replay ran {per} K1/K2 kernels")


def recount_after_native(torch, name, engine, frames, k1_per_frame,
                         k2_per_frame, device, n=3):
    """One profiler session of ``n`` replays of ``name``'s frame graph
    after ``phase_native``, informational (``phase_profiled`` held the
    counts before any int8 artifact ran in this process): K1 and K2
    records a replay against the graph's ``k1_per_frame`` +
    ``k2_per_frame``, device events a replay, and each kernel name whose
    records are not a whole number a replay (a record lost, or filed
    under another name).  Returns K1 and K2 a replay."""
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    _, events, per = replay_kernels(engine, dev_frame, n=n)
    counts = {}
    for e in events:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    odd = sorted((k, v) for k, v in counts.items() if v % n)
    log(f"{name} after phase_native: {n} replays in one profiler session: "
        f"{per[0]:g} K1 + {per[1]:g} K2 a replay (the graph holds "
        f"{k1_per_frame} + {k2_per_frame}), {len(events) / n:g} device "
        f"events a replay; kernel names whose records are not a whole "
        f"number a replay: "
        + (", ".join(f"{k[:90]} {v}" for k, v in odd) or "none"))
    return per


def drive_path(torch, name, config, seed, device, k1_per_frame,
               k2_per_frame, n_frames=FRAMES, ref_frames=REF_FRAMES,
               transform=None, cut=None):
    """One serving path at full frame: the launch counts set to 0, the
    engine built (warm-up steps and the capture of the frame graph) and
    ``n_frames`` frames through ``Engine.process``; the counts read and
    the graph's recorded launches checked; the output checked; a step
    checked for synchronising calls; the first ``ref_frames`` frames
    held against the same engine on the CPU; replays held against eager
    steps.  ``transform`` makes the served params from the seeded float
    ones (``built.params``), e.g. ``quantize_params_int8``.  With
    ``cut`` (the transform of the cut model's params, or ``True`` for
    ``transform``) the CPU reference runs on the architecture cut by
    ``cut_depth``, against an engine of the same on the card."""
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.runtime.engine import BUILD_STEPS, Engine

    t0 = time.perf_counter()
    built = create_models(config, seed=seed)["inference"]
    params = seeded_params(built, seed)
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
    steps = BUILD_STEPS
    log(f"{name}: engine built ({BUILD_STEPS - 2} warm-up steps, the plain "
        f"and the marked graph captured) "
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

    # The same engine on the CPU (plain versions), same params and frames;
    # with ``cut``, the cut architecture on both sides.
    label, model, ref_params, card = name, built.obj, params, outs
    if cut is not None:
        small = create_models(cut_depth(config), seed=seed)["inference"]
        model, ref_params = small.obj, seeded_params(small, seed)
        fn = transform if cut is True else cut
        if fn is not None:
            ref_params = fn(ref_params)
        cut_engine = Engine(model, ref_params, device=device)
        card = [cut_engine.process(f) for f in frames[:ref_frames]]
        label = f"{name} (cut to {CPU_CHECK_BLOCKS} res blocks a net)"
        del cut_engine
    cpu = Engine(model, ref_params, device="cpu")
    for i in range(ref_frames):
        card_vs_cpu(label, f"frame {i}", card[i], cpu.process(frames[i]))
    check_replay(torch, name, engine, frames, device)
    log(f"{name}: phase took {time.perf_counter() - t0:.1f} s")
    return engine, frames, k1, k2, built


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


def phase_runtime(torch, config, engine, built, frames, device, k2_ms,
                  seed):
    """The runtime around the engine on the quality tier: process_async
    and process_clip against streamed process (bit for bit), a
    VideoStream on the card against the same stream on the CPU (on the
    architecture cut to ``CPU_CHECK_BLOCKS`` res blocks a net),
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
    # a cache hit, a forward run; on the cut architecture.
    back, requests = 2, [0, 1, 2, 1, 5]
    small, small_params = cut_quality(torch, seed)
    sides = [(e, e.frames_processed, VideoStream(
        e, lambda i: frames[i], num_frames=len(frames), max_backtrack=back))
        for e in (Engine(small.obj, small_params, device=device),
                  Engine(small.obj, small_params, device="cpu"))]
    for n in requests:
        got, want = (stream.get_frame(n) for _, _, stream in sides)
        card_vs_cpu("VideoStream", f"frame {n}", got, want)
    calls = [e.frames_processed - before for e, before, _ in sides]
    log(f"runtime: VideoStream (max_backtrack {back}, requests {requests}; "
        f"the quality architecture cut to {CPU_CHECK_BLOCKS} res blocks a "
        f"net) on the card within bound of the CPU's; engine calls card/CPU "
        f"{calls[0]}/{calls[1]}")
    if calls[0] != calls[1] or calls[0] != 8:
        raise AssertionError(f"VideoStream made {calls} engine calls, not 8")
    del sides

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
        _, events = profiled(lambda: [fn() for _ in range(3)])
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
    phases); K1 at C = 48 (the PS2-fast generator) and C = 32 (the fast
    tier's flow net) timed."""
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
    out["k1_c32"], out["lib_ms_c32"] = time_k1(torch, device, 32)
    return out


def phase_variants(torch, seed, device, paths):
    """Every serving option on the PS2-fast architecture at full frame:
    launches, output, sync, replay and card-vs-CPU checks as for the
    tiers, the last on the architecture cut to ``CPU_CHECK_BLOCKS`` res
    blocks (each engine kept in ``paths``)."""
    launches = {}
    for name, (options, k1_per_frame, k2_per_frame) in VARIANTS.items():
        engine, frames, k1, k2, _ = drive_path(
            torch, f"variant {name}", ps2_config("ps2_fast", **options),
            seed, device, k1_per_frame, k2_per_frame,
            n_frames=VARIANT_FRAMES, ref_frames=VARIANT_FRAMES, cut=True)
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
    over 4 frames on the card (the card's range map held against the
    CPU's on the architecture cut to ``CPU_CHECK_BLOCKS`` res blocks a
    net, ``cut_quality``), and ``ps2_style`` (the autoencoder's
    256-channel convs: K = 2304, int32 sums past 2^24), each driven and
    checked as the float paths (launches from 0, sync, card vs CPU on
    the cut architecture, replays vs eager), timed, and held against the
    float tier's frames (informational)."""
    from joshupscale_torch.export.quantize import (
        calibrate,
        quantize_params_int8,
    )

    out = {}

    def run(name, config, transform, cut=True):
        engine, frames, k1, k2, built = drive_path(
            torch, name, config, seed, device, 0, 1,
            ref_frames=INT8_REF_FRAMES, transform=transform, cut=cut)
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
    # flow: conv_1, the head, 10 blocks; generator: conv_1, 24 blocks.
    if len(ranges) != 3 + 2 * 34:
        raise AssertionError(f"calibration keys: {len(ranges)} on the card")
    # The card against the CPU on the cut architecture (calibrate is held
    # against the reference in tests/test_torch_quantize.py).
    small, small_params = cut_quality(torch, seed)
    t0 = time.perf_counter()
    ranges_cut = calibrate(small.obj, small_params, cal, method="minmax",
                           device=device)
    t_cut = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranges_cpu = calibrate(small.obj, small_params, cal, method="minmax",
                           device="cpu")
    t_cpu = time.perf_counter() - t0
    if (sorted(ranges_cut) != sorted(ranges_cpu)
            or len(ranges_cut) != 3 + 4 * CPU_CHECK_BLOCKS):
        raise AssertionError(f"calibration keys differ: {len(ranges_cut)} "
                             f"on the card, {len(ranges_cpu)} on the CPU")
    gap = max(abs(ranges_cut[k] - ranges_cpu[k]) / ranges_cpu[k]
              for k in ranges_cut)
    log(f"calibrate(minmax) over 4 frames: {len(ranges)} conv inputs "
        f"(flow.conv_1 ... generator.block_24.conv_2) on the card in "
        f"{t_card:.1f} s; cut to {CPU_CHECK_BLOCKS} res blocks a net "
        f"({len(ranges_cut)} conv inputs), card {t_cut:.1f} s, CPU "
        f"{t_cpu:.1f} s: largest relative gap between the two range maps "
        f"{gap:.3g}")
    out["calibration"] = {"keys": len(ranges), "max_rel_gap": gap,
                          "card_s": t_card, "cpu_s": t_cpu,
                          "ranges": ranges}
    run("int8 quality calibrated", quality_config(),
        lambda p: quantize_params_int8(p, ranges=ranges),
        lambda p: quantize_params_int8(p, ranges=ranges_cut))
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
    latency and ``process_async`` throughput beside ``Engine``'s, and
    each stage graph's time alone with the payload's bytes
    (``tools/pipeline_probe.py``).  The 2-stream engine and a batch go
    into ``keep`` for the profiler."""
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.parallel import PipelinedEngine, ShardedEngine
    from joshupscale_torch.runtime.engine import BUILD_STEPS, Engine
    from joshupscale_torch.tools import pipeline_probe
    from joshupscale_torch.tools.timing import cuda_time_ms

    built = create_models(quality_config(), seed=seed)["inference"]
    params = seeded_params(built, seed)
    frames = frames_for(FRAMES, seed)
    nf = len(frames)
    kernels = all_kernels()
    steps = BUILD_STEPS
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
    # no marked graph: one capture fewer than an Engine's
    if (k1 != K1_PER_FRAME * (steps - 1) + flow_k1 or k2 != steps - 1
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
    # pipeline_probe: each stage graph replayed alone (moves the state).
    stages_ms = pipeline_probe.stage_times(piped)
    piped.reset()
    payload = pipeline_probe.payload_bytes(piped._inter)
    log(f"pipeline_probe: stage F (flow graph) {stages_ms['stage_f_ms']:.3f}"
        f" ms, stage G (generator graph) {stages_ms['stage_g_ms']:.3f} ms "
        f"(CUDA events, back to back; {stages_ms['stage_f_host_ms']:.3f} / "
        f"{stages_ms['stage_g_host_ms']:.3f} with host launch gaps); payload "
        f"{payload / 1e6:.3f} MB; transfer between cards "
        f"{pipeline_probe.ONE_CARD}")
    res["pipelined"] = {"k1": k1, "k2": k2, "ms": lat["pipelined"],
                        "engine_ms": lat["engine"],
                        "async_fps": fps["pipelined"],
                        "engine_async_fps": fps["engine"],
                        "payload_bytes": payload, **stages_ms}
    return res


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
        log_parts(name, engine, torch.from_numpy(frames[0][None]).to(device),
                  log)
    for name, (engine, dev_batch) in batched.items():
        log_parts(name, engine, dev_batch, log)
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
    from joshupscale_torch.runtime.engine import BUILD_STEPS, create_runtime

    frames = frames_for(FRAMES, seed)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    engine = create_runtime(package, device=device)
    outs = [engine.process(f) for f in frames]
    torch.cuda.synchronize()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    steps = BUILD_STEPS
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

    # The timed setups stay (warm) for the training profiles.
    res["batch"] = device_normalize(batches[0], device)
    res["batches"] = batches
    res["setups"] = {}
    for dtype in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        timed = build_training(train_config(out_dir, dtype), seed, device)
        res[dtype] = time_train_steps(torch, timed, res["batch"], seed, base)
        res["setups"][dtype] = timed
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
# Card vs CPU, one float32 step (TF32 off), written before the first
# run: each loss term within 1e-4 relative, each gradient of both groups
# within 1e-3 relative L2; the play prediction within 1e-3.  The first
# run showed the generator group's gradients move by 4% on the card
# alone under a 1e-7 relative nudge of the first convs' kernels (the
# warp's gradient in the flow jumps where a flow crosses an integer, and
# the 19-step sums cancel), as far as card and CPU differ: so each
# group is held to the larger of 1e-3 and 3x its largest change under
# three such nudges (``GAN_NUDGES``), and the 1e-3 verdict is printed.
# The step runs at the phase's batch with both resnets cut to
# ``CPU_CHECK_BLOCKS`` res blocks (the CPU side at full depth was the
# phase's longest part; ``tests/test_torch_gan.py`` holds the step
# against the reference).
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


def gan_card_vs_cpu(torch, config, batch_np, seed, device):
    """One float32 step of ``config``'s GAN, its resnets cut to
    ``CPU_CHECK_BLOCKS`` res blocks (``build_gan`` of ``cut_depth``), on
    the card against the CPU from the same params, batch and noise: every
    loss term, every gradient of both groups, the gate decision and
    ``discr_steps``.  The gradients are held to ``GAN_GRAD_RTOL`` or 3x
    the card's own largest change under the ``GAN_NUDGES`` of the first
    convs' kernels, whichever is larger."""
    setup = build_gan(torch, dict(config, models=cut_depth(config["models"])),
                      seed, device)
    trainer = setup.built.obj
    b = len(batch_np["input"])
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
    log(f"gan f32 card vs CPU (batch {b}, flow and generator cut to "
        f"{CPU_CHECK_BLOCKS} res blocks; card {card[4]:.1f} s, CPU "
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
    one float32 step on the card against the CPU (both resnets cut to
    ``CPU_CHECK_BLOCKS`` res blocks); the gate forced shut
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
    res["card_vs_cpu"] = gan_card_vs_cpu(torch, config, batches[0], seed,
                                         device)
    res["batch"] = dev_batch = device_normalize(batches[0], device)
    state = gan_gate_shut(torch, setup, state, dev_batch)
    # The timed setups stay (warm) for the training profiles.
    res["setups"] = {}
    for dtype in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        timed = build_gan(torch, gan_config(out_dir, dtype), seed, device)
        res[dtype] = time_gan_steps(torch, timed, dev_batch, seed, base)
        res["setups"][dtype] = timed
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


# The model-quality tools on the card (phase_lifecycle): a rendered synth
# set (4 train, 2 val sequences of 64x64 HR crops), the zero-init PSNR
# bound, the drift clip's source size and the soak's shape.
TOOL_LATENCY_FRAMES = 200  # latency_probe's frames, after 8 untimed
TOOL_CHECK_FRAMES = 4  # serving_check's frames
TOOL_GAN_STEPS = (2, 1)  # fit_cost_probe's long and short runs


def phase_tools(torch, seed, device, engine, gan_setup):
    """The measurement tools of ``joshupscale_torch/tools/`` that no
    other phase runs, on the card, before any profiler session (their
    clocks are the host's too): ``latency_probe`` over
    ``TOOL_LATENCY_FRAMES`` frames of the quality tier's ``engine`` (its
    launches were counted when it was built), ``serving_check`` on
    ``TOOL_CHECK_FRAMES`` of them, ``gather_relayout_probe`` at 270x480,
    and on ``phase_gan``'s bf16 setup (warm: no warm-up steps of its
    own) ``fit_cost_probe`` A, B and G over 2 against 1 step,
    ``fit_overlap_bench``'s lag 0 and 1 over 1 step each and one of
    ``train_step_bench``'s timed rounds.  The other tools'
    functions run in the phases: ``pipeline_probe`` in
    ``phase_parallel``, ``profile_step`` in ``phase_profiled`` (the
    graphs' kernel counts, ``log_parts``), ``run_native`` in
    ``phase_native``, ``profile_train_step`` in the training
    profiles."""
    from joshupscale_torch.tools import (
        fit_cost_probe,
        fit_overlap_bench,
        gather_relayout_probe,
        latency_probe,
        serving_check,
        train_step_bench,
    )
    from joshupscale_torch.training.trainer import init_gan_state

    t0 = time.perf_counter()
    frames = np.random.default_rng(seed).integers(
        0, 256, (8 + TOOL_LATENCY_FRAMES, H, W, 3), np.uint8)
    engine.reset()
    lat = latency_probe.probe(engine, frames, 8)
    for what, s in (("device", lat["device"]), ("Engine.process",
                                                 lat["process"])):
        log(f"latency_probe quality, {what}, {TOOL_LATENCY_FRAMES} frames: "
            f"mean {s['mean_ms']:.3f} ms, p50 {s['p50_ms']:.3f}, p90 "
            f"{s['p90_ms']:.3f}, p99 {s['p99_ms']:.3f}, max "
            f"{s['max_ms']:.3f} (p50 < {latency_probe.TARGET_MS} ms: "
            f"{s['p50_ms'] < latency_probe.TARGET_MS})")
    checked = serving_check.check(engine, frames[:TOOL_CHECK_FRAMES], log)
    engine.reset()
    gather = gather_relayout_probe.run(H, W, seed, device, log)

    s = gan_setup
    batch, crop = TRAIN_BATCH, TRAIN_CROP

    def fresh():
        return init_gan_state(s.built.obj, s.built.params["gen"],
                              s.built.params["discr"], s.optimizer,
                              s.discr_optimizer, device)

    cost = fit_cost_probe.run(*TOOL_GAN_STEPS, 1, crop, batch, "A,B,G",
                              device, gan=(s.built, s.step, fresh), warm=0,
                              log=log)
    lags = fit_overlap_bench.run_lags(s.step, fresh, device, batch, crop, 1,
                                      runs=fit_overlap_bench.RUNS[:2],
                                      warm=0, log=log)
    rounds = train_step_bench.time_rounds(
        s.step, fresh(), train_step_bench.batches(1, batch, crop, device,
                                                  seed),
        "gen_loss", 1, device, torch.Generator(device).manual_seed(seed))
    log(f"train_step_bench gan bf16 (phase_gan's setup): "
        f"{rounds['ms_per_step']:.1f} ms a step by the host clock, "
        f"{rounds['event_ms_per_step']:.1f} by CUDA events, peak "
        f"{rounds['peak_gib']:.2f} GiB")
    seconds = time.perf_counter() - t0
    log(f"tools: phase took {seconds:.1f} s")
    return {"latency": lat, "serving_check": checked, "gather": gather,
            "fit_cost": cost, "fit_lags": lags, "train_rounds": rounds,
            "seconds": seconds}


LIFE_SOURCE = os.path.join(HERE, "docs", "learned_compare.png")
LIFE_TRAIN, LIFE_VAL, LIFE_HR = 4, 2, 64
LIFE_BN_BATCHES = 4
LIFE_ZERO_INIT_DB = 0.1  # zero tails serve the bilinear skip
LIFE_CARD_VS_CPU_DB = 0.1  # eval_synth's PSNRs, card against CPU
LIFE_DRIFT_SOURCE = 1728  # 576 upscaled x3: wider than 2 x 480 + 600
LIFE_FULLRES_FRAMES = 10
LIFE_SOAK = {"steps": 6, "crop": 32, "batch": 2}


def life_tool(name, argv):
    """``learning_run.run_tool`` of the tool ``name``: its output and
    seconds logged; returns the output."""
    from joshupscale_torch.tools.learning_run import run_tool

    def echo(line):
        if line.strip():
            log(f"  {name}: {line.strip()}")

    text, seconds = run_tool(name, argv, echo)
    log(f"lifecycle {name} {' '.join(map(str, argv[1:]))}: exit 0 in "
        f"{seconds:.1f} s")
    return text


def phase_lifecycle(torch, seed, device, out_dir, checkpoint):
    """The model-quality tools (``joshupscale_torch/tools/``) on the card,
    in this process, through their ``main``s: ``make_synth_dataset``
    renders a small set from ``docs/learned_compare.png``;
    ``bn_recalibrate`` runs over ``LIFE_BN_BATCHES`` batches of it on
    ``phase_train``'s FRVSR checkpoint (only moving-statistic leaves
    change, all finite); ``eval_synth`` on that checkpoint (card and CPU
    PSNRs compared), with ``--zero-init`` (within ``LIFE_ZERO_INIT_DB``
    of bilinear x4) and with ``--u8-state --pingpong``;
    ``eval_serving_fullres`` at 270x480, ``drift_1000`` at its full T =
    1000 and width with the launch counts set to 0 first (three quality
    engines: 68 K1 + 1 K2 a warm-up or captured step; the counts see no
    replay of a captured graph: ``phase_profiled`` counts the quality
    path's graph; stream against clip 0 u8 steps: both replay the one
    captured graph), both on the
    source upscaled to ``LIFE_DRIFT_SOURCE``; ``gan_soak``'s full-width
    TecoGAN step ``LIFE_SOAK`` (finite losses).  Returns the figures."""
    import re

    import cv2

    from joshupscale_torch.runtime.engine import BUILD_STEPS
    from joshupscale_torch.tools.gan_soak import soak
    from joshupscale_torch.tools.val_data import report_psnrs

    started = time.perf_counter()
    data = os.path.join(out_dir, "synth")
    life_tool("make_synth_dataset", [
        data, "--source", LIFE_SOURCE, "--train", LIFE_TRAIN, "--val",
        LIFE_VAL, "--hr-size", LIFE_HR, "--seed", seed])
    crop = LIFE_HR // 8  # LR crops of half a frame
    config = {"models": TRAIN_MODELS, "train_dataset": [
        {"name": "LocalDatasetOp",
         "lr_path": os.path.join(data, "train", "lr", "*.png"),
         "hr_path": os.path.join(data, "train", "hr", "*.png"),
         "shuffle": True},
        {"name": "RandomCropOp", "crop_size": crop, "num_img": 10},
        {"name": "NormalizeOp", "crop_size": crop},
        {"name": "RepeatOp"}]}
    config_path = os.path.join(out_dir, "lifecycle.yaml")
    with open(config_path, "w") as f:
        json.dump(config, f)  # JSON is YAML
    recal = os.path.join(out_dir, "bncal.npz")
    life_tool("bn_recalibrate", [checkpoint, "-c", config_path, "-o", recal,
                                "--batches", LIFE_BN_BATCHES,
                                "--batch-size", TRAIN_BATCH])
    with np.load(checkpoint) as a, np.load(recal) as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError("bn_recalibrate changed the key set")
        changed = [k for k in a.files if not np.array_equal(a[k], b[k])]
        stats = [k for k in a.files if k.startswith("params.")
                 and k.endswith(("moving_mean", "moving_variance"))]
        finite = all(np.all(np.isfinite(b[k])) for k in stats)
        leaves = len(a.files)
    log(f"lifecycle bn_recalibrate: {len(changed)} of the checkpoint's "
        f"{leaves} leaves changed, {len(stats)} moving statistics in its "
        f"params; other leaves changed: {sorted(set(changed) - set(stats))};"
        f" all finite: {finite}")
    if set(changed) != set(stats) or not stats or not finite:
        raise AssertionError("bn_recalibrate changed a leaf other than the "
                             "moving statistics, missed one, or made one "
                             "non-finite")

    res = {"bn_changed": len(changed), "bn_stats": len(stats)}
    out = life_tool("eval_synth", [checkpoint, "--data", data])
    cpu = life_tool("eval_synth", [checkpoint, "--data", data, "--cpu"])
    res["psnr"], res["psnr_cpu"] = report_psnrs(out), report_psnrs(cpu)
    gap = max(abs(c - p) for c, p in zip(res["psnr"], res["psnr_cpu"]))
    if gap > LIFE_CARD_VS_CPU_DB:
        raise AssertionError(f"eval_synth: card and CPU PSNRs differ by "
                             f"{gap:.2f} dB")
    model, bilinear = report_psnrs(life_tool("eval_synth", [
        "random", "--zero-init", "--data", data]))
    res["zero_init"] = (model, bilinear)
    if abs(model - bilinear) > LIFE_ZERO_INIT_DB:
        raise AssertionError(f"eval_synth --zero-init: {model:.2f} dB "
                             f"against bilinear {bilinear:.2f}")
    out = life_tool("eval_synth", [checkpoint, "--data", data, "--u8-state",
                                  "--pingpong"])
    res["u8_state"] = report_psnrs(out)
    res["pingpong"] = float(re.search(r"ping-pong inconsistency: ([0-9.]+)",
                                      out).group(1))

    big = os.path.join(out_dir, "drift_source.png")
    src = cv2.imread(LIFE_SOURCE, cv2.IMREAD_COLOR)
    cv2.imwrite(big, cv2.resize(src, (LIFE_DRIFT_SOURCE, LIFE_DRIFT_SOURCE),
                                interpolation=cv2.INTER_CUBIC))
    res["fullres"] = report_psnrs(life_tool("eval_serving_fullres", [
        checkpoint, "--source", big, "--frames", LIFE_FULLRES_FRAMES]))

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = life_tool("drift_1000", ["--source", big])
    torch.cuda.synchronize()
    k1, k2, p1, p2 = (k.launches for k in kernels)
    steps = 3 * BUILD_STEPS
    summary = json.loads(out.strip().splitlines()[-1])
    u8 = summary["u8_state_vs_float"]
    res.update(drift_s=time.perf_counter() - t0, drift=summary,
               launches=(k1, k2))
    log(f"lifecycle drift_1000 (T = {summary['frames']}, 270x480, quality "
        f"bf16): K1 launches {k1} ({k1 / steps:g} a warm-up or captured "
        f"step of 3 engines; the clip's graph replays are not counted), "
        f"K2 {k2}, P1/P2 {p1}/{p2}; stream vs clip "
        f"{summary['stream_vs_clip_max_u8']}; u8 state vs float: mean "
        f"{u8['mean_u8_steps_overall']:.4f}, pooled p99 "
        f"{u8['p99_u8_steps_overall']}, p99 of frame p99s "
        f"{u8['p99_of_frame_p99s']:.1f}, max {u8['max_u8_steps_overall']}; "
        f"mean by checkpoint {u8['mean_by_checkpoint']}, max by checkpoint "
        f"{u8['max_by_checkpoint']}")
    if (k1 != K1_PER_FRAME * steps or k2 != steps or p1 or p2
            or summary["frames"] != 1000
            or set(summary["stream_vs_clip_max_u8"].values()) != {0}):
        raise AssertionError("drift_1000: launches off 68 K1 + 1 K2 a step, "
                             "or stream and clip differ")

    t0 = time.perf_counter()
    history, steps_s = soak(LIFE_SOAK["steps"], LIFE_SOAK["crop"],
                            LIFE_SOAK["batch"], device, log_every=1,
                            log=lambda m: log(f"  gan_soak: {m}"))
    if history is None or len(history) != LIFE_SOAK["steps"]:
        raise AssertionError("gan_soak: a non-finite loss")
    res["soak"] = {k: [m[k] for m in history]
                   for k in ("gen_loss", "content_loss", "discr_loss")}
    log(f"lifecycle gan_soak ({LIFE_SOAK['steps']} full-width steps, crop "
        f"{LIFE_SOAK['crop']}, batch {LIFE_SOAK['batch']}): "
        f"{steps_s / LIFE_SOAK['steps'] * 1e3:.0f} ms a step, "
        f"{time.perf_counter() - t0:.1f} s with the build; gen_loss "
        f"{['%.4f' % x for x in res['soak']['gen_loss']]}")
    res["seconds"] = time.perf_counter() - started
    log(f"lifecycle: phase took {res['seconds']:.1f} s")
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


NATIVE_CHECKED = 20  # frames of each tier held against Engine.process
# Frames of the two upscale_cli runs of a timing: the checked run (its
# frames written to a file) and a long run to /dev/null.  A frame's time
# is the long run's steady interval taken from outside the process
# (``run_native.steady_ms``); the CLI's own difference quotient of the
# two runs is printed beside it (``run_native.quotient_ms``).
NATIVE_RUNS = (NATIVE_CHECKED, 320)
# The OBS model set (joshupscale_torch.tools.make_model_set): each tier's
# K1 launches a frame (and 1 K2).  Two make_model_set processes write it
# side by side, each exporting its two tiers one after the other.
NATIVE_TIERS = {"model_psp": K1_PER_FRAME, "model_psp_fast": 2 * (6 + 12),
                "model_ps2": 2 * 24, "model_ps2_fast": 2 * 12}
NATIVE_SET_PROCESSES = (("model_psp_fast", "model_psp"),
                        ("model_ps2_fast", "model_ps2"))
# model_psp_fast's flow head is scaled to a mean |flow| of NATIVE_FLOW HR
# pixels (one LR pixel), so that a wrong flow net inside its artifact
# (the traced-conv fault showed at its 32 / 48 widths) shows in its frames
# and state.
NATIVE_FLOW_FRAMES = 6
NATIVE_FLOW = 4.0
NATIVE_MIN_FLOW = 2.0


def state_vs_engine(name, what, got, ref):
    """A float state leaf of the artifact against ``Engine``'s, held to
    the card-vs-CPU gate in u8 steps (the state's unit is 1/255 of the
    display's range): mean 0.5, 1% of the values off by more than 2.
    Returns the largest difference in u8 steps."""
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64)) * 255
    mean_d, share = float(diff.mean()), float((diff > 2).mean())
    if mean_d > 0.5 or share > 0.01:
        raise AssertionError(f"{name}: {what} differs from Engine's beyond "
                             f"the bound (mean {mean_d:.4f} u8 steps, "
                             f"{share:.5f} off by more than 2)")
    return float(diff.max())


def native_step_check(torch, name, step, engine, frames, device):
    """``frames`` through the loaded artifact ``step`` and through
    ``engine`` (fresh) side by side: every display frame within the
    card-vs-CPU gate (``card_vs_cpu``) and every float state leaf after
    every frame within it too (``state_vs_engine``).  Returns the largest
    display and state differences in u8 steps and ``engine``'s frames."""
    from joshupscale_torch.export.package import state_leaves

    state = state_leaves(engine.model.init_state(1, device=device))
    shown, kept = [], 0.0
    for i, f in enumerate(frames):
        with torch.no_grad():
            out, *state = step(torch.from_numpy(f[None]).to(device), *state)
        shown.append((out[0].cpu().numpy(), engine.process(f)))
        for leaf, ref in zip(state, state_leaves(engine.state)):
            if leaf.is_floating_point():
                kept = max(kept, state_vs_engine(
                    name, f"state leaf {tuple(leaf.shape)} after frame {i}",
                    leaf.float().cpu().numpy(), ref.float().cpu().numpy()))
    shown_max = card_vs_cpu(name, f"{len(frames)} frames in process",
                            np.stack([a for a, _ in shown]),
                            np.stack([b for _, b in shown]),
                            against="Engine.process")
    log(f"{name}: float state leaves after each of {len(frames)} frames "
        f"within the gate of Engine's, largest difference {kept:.3f} u8 "
        f"steps")
    return shown_max, kept, np.stack([b for _, b in shown])


def tier_weights(torch, name, seed, device, path):
    """The weights ``make_model_set --weights`` takes for tier ``name``,
    written to ``path`` (a raw params ``.npz``): the registry's random
    init from ``seed`` through ``seeded_params``; for ``model_psp_fast``
    the flow head (linear) is then scaled so that the mean |flow| over
    ``NATIVE_FLOW_FRAMES`` frames (eager, HR pixels) is ``NATIVE_FLOW``,
    at least ``NATIVE_MIN_FLOW`` after bf16 rounding.  Returns that mean
    |flow|, or None."""
    from joshupscale_torch.export.package import load_model_config
    from joshupscale_torch.export.weights import to_flat_numpy
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.tools.export_isolation import scale_flow
    from joshupscale_torch.tools.make_model_set import MODEL_CONFIGS

    config = load_model_config(os.path.join(HERE, MODEL_CONFIGS[name]))
    built = create_models(config, seed=seed)["inference"]
    params = seeded_params(built, seed)
    flow = None
    if name == "model_psp_fast":
        frames = frames_for(NATIVE_FLOW_FRAMES, seed + 1)
        raw, flow = scale_flow(torch, built, frames, device, NATIVE_FLOW)
        log(f"native {name}: mean |flow| {flow:.3f} HR pixels over frames "
            f"2..{len(frames)} ({raw:.3f} before the head was scaled)")
        if flow < NATIVE_MIN_FLOW:
            raise AssertionError(f"native {name}: the flows are too small "
                                 f"to test the artifact's flow net")
    np.savez(path, **to_flat_numpy(params))
    return flow


def set_process(names, cmd, log_path):
    """Start one exporting process of the set, ``cmd`` from the repo root
    with the repo importable, its output written to ``log_path`` (a pipe
    left unread while other processes are collected could fill and stall
    it): ``(names, process, start time, log_path)``."""
    import subprocess

    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=HERE, env=repo_env(), stdout=out,
                                stderr=subprocess.STDOUT, text=True)
    return names, proc, time.perf_counter(), log_path


def start_model_set(out, weights, seed, log_dir):
    """The four float tiers' packages with their ``step.pt2`` sets for the
    card, written by ``python -m joshupscale_torch.tools.make_model_set``
    into ``out``: one process for each entry of ``NATIVE_SET_PROCESSES``,
    started side by side, each exporting its tiers one after the other
    (``set_process``)."""
    procs = []
    for names in NATIVE_SET_PROCESSES:
        cmd = [sys.executable, "-m", "joshupscale_torch.tools.make_model_set",
               "--out", out, "--seed", str(seed), "--models", *names]
        for n in names:
            cmd += ["--weights", f"{n}={weights[n]}"]
        procs.append(set_process(names, cmd, os.path.join(
            log_dir, f"{names[0]}_export.log")))
    return procs


def start_int8_export(out, seed, ranges, log_dir):
    """The int8 tiers' exporting processes (``export_int8_tiers`` into
    ``out``), one for each entry of ``NATIVE_INT8_PROCESSES``, started
    side by side; ``ranges``, the calibrated tier's range map, passed on
    in ``int8_ranges.json``."""
    ranges_path = os.path.join(log_dir, "int8_ranges.json")
    with open(ranges_path, "w") as f:
        json.dump(ranges, f)
    return [set_process(names, [
        sys.executable, "-c", "import sys, chip_smoke; "
        "sys.exit(chip_smoke.export_int8_tiers(*sys.argv[1:]))",
        out, str(seed), ranges_path, *names],
        os.path.join(log_dir, f"{names[0]}_export.log"))
        for names in NATIVE_INT8_PROCESSES]


def collect_set(procs):
    """Wait for the exporting processes ``procs`` (``set_process``):
    each tier's export + compile seconds as the processes print them,
    each process's wall seconds, and each int8 tier's ``aten._int_mm``
    nodes and quantized convs.  A failed process raises with its
    output."""
    import re
    import subprocess

    compile_s, wall_s, int_mm, failed = {}, {}, {}, []
    for names, proc, t0, log_path in procs:
        try:
            proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        wall_s[names] = time.perf_counter() - t0
        with open(log_path) as f:
            text = f.read()
        for n, sec in re.findall(r"\[(\w+)\] step\.pt2 for \S+ written in "
                                 r"([0-9.]+) s", text):
            compile_s[n] = float(sec)
        for n, nodes, convs in re.findall(
                r"\[(\w+)\] .* (\d+) aten\._int_mm nodes, (\d+) quantized "
                r"convs", text):
            int_mm[n] = (int(nodes), int(convs))
        if proc.returncode != 0 or set(names) - set(compile_s):
            failed.append(f"{' + '.join(names)} (exit {proc.returncode}):"
                          f"\n{text[-4000:]}")
    if failed:
        raise AssertionError("model set: a process failed: "
                             + "\n".join(failed))
    return compile_s, wall_s, int_mm


def stop_processes(procs):
    """Kill whichever of the exporting processes ``procs`` still run."""
    for _, proc, _, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def host_pattern(h, w):
    """The fake OBS host's source frame (``fake_obs_host.cc``
    ``stagePattern``) in the model's row order."""
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(y * 31 + x * 7 + c * 3) % 256 for c in range(3)],
                    -1).astype(np.uint8)


def masked_compose(out, orig, mask):
    """``native/src/compose.cc``: the original frame and the keep-mask
    scaled (nearest) to the output, blended in fixed point; a keep of 255
    passes the upscale through untouched."""
    oh, ow, _ = out.shape
    o = orig[np.arange(oh) * orig.shape[0] // oh][
        :, np.arange(ow) * orig.shape[1] // ow].astype(np.uint32)
    keep = mask[np.arange(oh) * mask.shape[0] // oh][
        :, np.arange(ow) * mask.shape[1] // ow].astype(np.uint32)[..., None]
    v = o * (255 - keep) + out.astype(np.uint32) * keep + 128
    composed = ((v + (v >> 8)) >> 8).astype(np.uint8)
    return np.where(keep == 255, out, composed).astype(np.uint8)


def native_obs(torch, host, set_dir, engines, out_dir):
    """The fake OBS host (``native/tests/fake_obs_host.cc``) over the
    set with the Python-free backend on the card: render ``model_psp``
    twice, swap to ``model_ps2`` (the masked HUD compose with the set's
    ``mask.png``), a missing model, and the recovery.  The set's view
    leaves ``model_ps2_fast`` out, so that the host has a model to miss.
    Each presented frame is held to ``Engine``'s (the compose replayed
    in numpy for the PS2 frames) within the card-vs-CPU gate.  Returns
    the largest u8 difference."""
    import subprocess

    from PIL import Image

    view = os.path.join(out_dir, "obs_view")
    os.makedirs(view)
    for name in ("model_psp", "model_ps2", "mask.png"):
        os.symlink(os.path.join(set_dir, name), os.path.join(view, name))
    out = os.path.join(out_dir, "obs_out")
    os.makedirs(out)
    proc = subprocess.run([os.path.join(host, "fake_obs_host"), view, out],
                          env=repo_env(aoti=True), capture_output=True,
                          text=True, timeout=600)
    if (proc.returncode != 0 or "fake obs host OK" not in proc.stdout
            or "AOTInductor engine loaded" not in proc.stderr):
        raise AssertionError(f"fake_obs_host failed (exit "
                             f"{proc.returncode}):\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")

    def presented(name):
        raw = np.fromfile(os.path.join(out, name), np.uint8)
        return raw.reshape(4 * H, 4 * W, 4)[:, :, :3]  # BGRX -> BGR

    pattern = host_pattern(H, W)
    for engine in engines.values():
        engine.reset()
    psp = [engines["model_psp"].process(pattern) for _ in range(2)]
    mask = np.asarray(Image.open(os.path.join(set_dir, "mask.png")))
    ps2 = masked_compose(engines["model_ps2"].process(pattern), pattern,
                         mask)
    return max(card_vs_cpu("native obs", f"presented {name}",
                           presented(name), ref, against="Engine.process")
               for name, ref in (("psp_0.raw", psp[0]), ("psp_1.raw", psp[1]),
                                 ("ps2_0.raw", ps2),
                                 ("ps2_recovered.raw", ps2)))


def native_installed(host, out_dir, package, frames, want):
    """``cmake --install`` of the host into a prefix under ``out_dir``,
    then the Python-free ``upscale_cli`` of the prefix on ``package`` with
    the port's build trees (``joshupscale_torch/_build``: the host, the op
    library, the kernels' libraries) moved away: its frames must be
    ``want``, the build tree's own ``upscale_cli`` output, byte for byte.
    The trees are moved back after it, whatever happens."""
    import subprocess

    from joshupscale_torch import native

    prefix = os.path.join(out_dir, "prefix")
    proc = subprocess.run(["cmake", "--install", host, "--prefix", prefix],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"cmake --install failed:\n{proc.stdout}"
                             f"{proc.stderr}")
    trees = str(native.BUILD_DIR.parent)
    os.rename(trees, trees + ".moved")
    try:
        got = cli_run(host, package, frames[:len(want)], True, False,
                      keep=True, cli=os.path.join(prefix, "bin",
                                                  "upscale_cli"))["out"]
    finally:
        os.rename(trees + ".moved", trees)
    exact = bool(np.array_equal(got, want))
    log(f"native installed: upscale_cli of the install prefix, with "
        f"{trees} moved away, served {len(want)} frames bit for bit with "
        f"the build tree's: {exact}")
    if not exact:
        raise AssertionError("native installed: the installed host's "
                             "frames differ from the build tree's")


def native_check(torch, name, package, step, model, params, frames, device,
                 host, engine=None):
    """The loaded artifact ``step`` of the package at ``package`` against
    ``Engine`` on ``model`` and ``params``: frames and float state over
    ``NATIVE_CHECKED`` frames (``native_step_check``; ``Engine``'s frames
    must not be clipped flat), then the Python-free ``upscale_cli``
    synchronous on the same frames within the card-vs-CPU gate of
    ``Engine.process``.  Untimed; the CLI's run (``cli_run``: its own
    clock and the outside stamps) serves as the short run of a timing
    only where no other process runs.  ``engine``: an ``Engine`` of the
    same model and params that an earlier phase built (reset here), in
    place of a new one.  Returns the results, ``Engine``'s frames, the
    engine (reset) and the CLI's frames."""
    from joshupscale_torch.runtime.engine import Engine

    if engine is None:
        engine = Engine(model, params, device=device)
    engine.reset()
    *step_diff, ref = native_step_check(
        torch, f"native {name}", step, engine, frames[:NATIVE_CHECKED],
        device)
    inside = float(((ref > 0) & (ref < 255)).mean())
    if inside < 0.5:
        raise AssertionError(f"native {name}: Engine's output mostly "
                             f"clipped ({inside:.4f} inside): the check is "
                             f"trivial")
    run = cli_run(host, package, frames[:NATIVE_CHECKED], True, False,
                  keep=True)
    got = run.pop("out")
    cli_diff = card_vs_cpu(f"native {name} upscale_cli aoti",
                           f"{NATIVE_CHECKED} frames", got, ref,
                           against="Engine.process")
    engine.reset()
    size_mb = os.path.getsize(os.path.join(package, "step.pt2")) / 2**20
    return {"step_diff": step_diff, "cli_diff": cli_diff, "cli_run": run,
            "size_mb": size_mb, "inside": inside}, ref, engine, got


# The int8 tiers as Python-free sets for the card: package directory ->
# (the phase_int8 path it serves, its architecture, calibrated scales).
NATIVE_INT8 = {"int8_quality": ("int8 quality", "quality", False),
               "int8_quality_calibrated": ("int8 quality calibrated",
                                           "quality", True),
               "int8_ps2_style": ("int8 ps2_style", "ps2_style", False)}
# Its exporting processes (``export_int8_tiers``), beside the
# make_model_set processes.  The calibrated tier reuses its process's
# kernels of the first; one process for all three was the longest part
# of the set (its exports run one after the other: 346.6 s alone on an
# H100's host, against 163-188 s for each float process).
NATIVE_INT8_PROCESSES = (("int8_quality", "int8_quality_calibrated"),
                         ("int8_ps2_style",))


def int8_tier(torch, name, seed, ranges):
    """The int8 tier ``name`` of ``NATIVE_INT8`` as ``phase_int8`` serves
    it: ``(config, built entry, int8 params)``, the params
    ``quantize_params_int8`` of the seeded float params (``ranges``, the
    card's ``calibrate`` map, where the tier is calibrated)."""
    from joshupscale_torch.export.quantize import quantize_params_int8
    from joshupscale_torch.models.registry import create_models

    _, arch, calibrated = NATIVE_INT8[name]
    config = quality_config() if arch == "quality" else ps2_config(arch)
    built = create_models(config, seed=seed)["inference"]
    params = seeded_params(built, seed)
    return config, built, quantize_params_int8(
        params, ranges=ranges if calibrated else None)


def export_int8_tiers(out: str, seed: str, ranges_path: str,
                      *names: str) -> int:
    """An int8 export process (``python -c``, ``start_int8_export``):
    the packages of the ``NATIVE_INT8`` tiers ``names`` under ``out``
    with their ``step.pt2`` sets compiled for the card
    (``save_package(..., export_aoti=True)`` of the int8 params), one
    after the other; prints each tier's export + compile seconds and its
    graph's ``aten._int_mm`` nodes beside its quantized convs."""
    import torch

    from joshupscale_torch.export.package import save_package
    from joshupscale_torch.export.quantize import quantized_convs

    bind_tools()
    with open(ranges_path) as f:
        ranges = json.load(f)
    for name in names:
        config, built, params = int8_tier(torch, name, int(seed), ranges)
        built.params = params
        t0 = time.perf_counter()
        program = save_package(os.path.join(out, name), config, built,
                               export_aoti=True)
        seconds = time.perf_counter() - t0
        nodes = sum(1 for n in program.graph.nodes
                    if n.op == "call_function"
                    and str(n.target) == "aten._int_mm.default")
        print(f"[{name}] step.pt2 for cuda written in {seconds:.1f} s; "
              f"{nodes} aten._int_mm nodes, {quantized_convs(params)} "
              f"quantized convs", flush=True)
    return 0


def native_refusal(host, package, frames_path):
    """The embedded-Python backend on an int8 package: ``load_package``
    takes float params only, so the host must fail with ``error:`` and
    the parameter mismatch (as the reference's ``NativeEngine`` raises).
    Returns the host's error line."""
    import subprocess

    proc = subprocess.run([os.path.join(host, "upscale_cli"), package,
                           frames_path, os.devnull, "1"], env=repo_env(),
                          capture_output=True, text=True, timeout=300)
    lines = [ln for ln in proc.stderr.splitlines() if "error:" in ln]
    if (proc.returncode == 0 or not lines
            or "parameter mismatch" not in proc.stderr):
        raise AssertionError(f"native int8: the embedded-Python backend "
                             f"did not refuse the int8 package (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    return lines[-1].strip()


def phase_native(torch, seed, device, out_dir, ops_build_s, engine_ms,
                 int8, paths):
    """Native serving over the port: the C++ host
    (``joshupscale_torch/native``; the op library was built before the
    kernels' first launch, ``ops_build_s``), the OBS model set and the
    int8 tiers on the Python-free backend.

    Exports: ``make_model_set`` writes the four float tiers at full
    width (270x480, bf16) with their ``step.pt2`` sets compiled on the
    card, each tier from a ``--weights`` npz of seeded params
    (``tier_weights``; ``model_psp_fast``'s flow head scaled to large
    flows), in two processes; beside them ``export_int8_tiers`` writes
    the three int8 tiers of ``phase_int8`` (``int8``, its results: the
    calibrated tier's ranges from the card's ``calibrate``; ``paths``,
    its engines, serve as their artifacts' references) in two more
    (``NATIVE_INT8_PROCESSES``); the host builds beside them (its build
    time is taken there).  While the int8 processes still run, only
    untimed checks run here: each float tier's artifact against
    ``Engine`` and through ``upscale_cli`` (``native_check``), the fake
    OBS host over the set (``native_obs``) and the installed host with
    the build trees moved away (``native_installed``).  Once every
    export has ended: each artifact's trace (``native_trace``: K1 + K2,
    0 + 1 on the int8 tiers with their int8 products, busy time by part;
    each session warmed up by one run) and its device time by CUDA
    events without the profiler, the float tiers' first, before any int8
    artifact runs in this process; the int8 tiers' graphs'
    ``aten._int_mm`` nodes against their quantized convs and their
    checks; the embedded-Python backend's refusal of an int8 package
    (``native_refusal``); on the quality tier ``model_psp`` the
    embedded-Python backend synchronous and ``--pipeline``, bit for bit
    with ``Engine.process`` (not timed: ``run_native --python`` times
    it); and the timings through ``upscale_cli`` on moving-pattern
    frames: the Python-free backend (within the card-vs-CPU gate) on
    ``model_psp`` and ``int8 quality``, each synchronous and
    ``--pipeline``.  A frame's time for each mode is the long run's
    steady frame interval taken from outside the
    process (``run_native``: frames fed through a FIFO, each stamped as
    the CLI takes it), printed with the CLI's own difference quotient of
    the short and the long run (``NATIVE_RUNS``) and its own figure,
    beside ``Engine.process``'s median (``engine_ms`` on quality, from
    ``phase_times``; the int8 tier's from ``phase_int8``).  The
    Python-free backend's time, synchronous and pipelined, must be at
    least the artifact's device time a frame (the smaller of its CUDA
    event time and its trace's busy time)."""
    from joshupscale_torch import native
    from joshupscale_torch.export.package import load_aoti_step, load_package
    from joshupscale_torch.tools.run_native import (
        head_s,
        quotient_ms,
        steady_ms,
    )

    started = time.perf_counter()
    set_dir = os.path.join(out_dir, "model_set")
    int8_dir = os.path.join(out_dir, "int8_set")
    # The int8 exports are the longest; they need no weights file.
    int8_procs = start_int8_export(int8_dir, seed,
                                   int8["calibration"]["ranges"], out_dir)
    float_procs = []
    try:
        weights = {n: os.path.join(out_dir, f"{n}_weights.npz")
                   for n in NATIVE_TIERS}
        flow = None
        for n, path in weights.items():
            flow = tier_weights(torch, n, seed, device, path) or flow
        float_procs = start_model_set(set_dir, weights, seed, out_dir)
        t0 = time.perf_counter()
        host = str(native.build())
        host_s = time.perf_counter() - t0
        log(f"native: host build (cmake + ninja, beside the four exporting "
            f"processes) {host_s:.1f} s, kernel and op library builds "
            f"{ops_build_s:.1f} s")
        compile_s, wall_s, _ = collect_set(float_procs)
        log("native set: make_model_set wrote the four tiers for the card, "
            "two processes side by side (and two int8 processes): "
            + "; ".join(f"process {' + '.join(names)}: " + ", ".join(
                f"{n} {compile_s[n]:.1f} s" for n in names)
                + f", {wall_s[names]:.1f} s in all" for names in wall_s))

        frames = frames_for(NATIVE_RUNS[1], seed)
        frames_path = os.path.join(out_dir, "native_frame.raw")
        frames[:1].tofile(frames_path)
        tiers, steps, engines = {}, {}, {}
        for name in NATIVE_TIERS:
            package = os.path.join(set_dir, name)
            model, params = load_package(package)
            steps[name] = (load_aoti_step(package), model)
            tiers[name], ref, engine, aoti_out = native_check(
                torch, name, package, steps[name][0], model, params, frames,
                device, host)
            tiers[name]["compile_s"] = compile_s[name]
            if name in ("model_psp", "model_ps2"):
                engines[name] = engine
            if name == "model_psp":
                quality_ref, quality_aoti = ref, aoti_out
            del engine
        obs_diff = native_obs(torch, host, set_dir, engines, out_dir)
        engines.clear()
        native_installed(host, out_dir, os.path.join(set_dir, "model_psp"),
                         frames, quality_aoti)
        t0 = time.perf_counter()
        int8_s, int8_wall, int_mm = collect_set(int8_procs)
    finally:
        stop_processes(float_procs + int8_procs)
    compile_s.update(int8_s)
    wall_s.update(int8_wall)
    log(f"native int8 set: export_int8_tiers wrote the int8 tiers for the "
        f"card, two processes beside the model set's (the checks above "
        f"ran {time.perf_counter() - t0:.1f} s before the last ended): "
        + "; ".join(f"process {' + '.join(names)}: " + ", ".join(
            f"{n} {int8_s[n]:.1f} s" for n in names)
            + f", {int8_wall[names]:.1f} s in all" for names in int8_wall))

    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    for name in NATIVE_TIERS:
        step, model = steps.pop(name)
        tiers[name].update(native_trace(name, step, model,
                                        NATIVE_TIERS[name], dev_frame, device))
        del step
    for d, (name, _, _) in NATIVE_INT8.items():
        # phase_int8's engine of the tier: the params export_int8_tiers
        # exported (int8_tier).
        engine = paths[name][0]
        nodes, convs = int_mm[d]
        log(f"native {name}: the exported graph holds {nodes} "
            f"aten._int_mm nodes for {convs} quantized convs")
        if nodes != convs:
            raise AssertionError(f"native {name}: {nodes} int8 products in "
                                 f"the graph, {convs} quantized convs")
        package = os.path.join(int8_dir, d)
        step = load_aoti_step(package)
        tiers[name] = native_trace(name, step, engine.model, 0, dev_frame,
                                   device)
        checked, ref, engine, _ = native_check(
            torch, name, package, step, engine.model, None, frames, device,
            host, engine=engine)
        tiers[name].update(checked, compile_s=compile_s[d], int_mm=nodes)
        if d == "int8_quality":
            int8_ref = ref
        del engine, step
    int8_package = os.path.join(int8_dir, "int8_quality")
    refusal = native_refusal(host, int8_package, frames_path)
    log(f"native int8 quality: the embedded-Python backend refuses the "
        f"package, as the reference's NativeEngine does: {refusal}")

    ms, check = {}, {}
    runs = [("python", "model_psp", m) for m in ("sync", "pipelined")]
    runs += [("aoti", "model_psp", m) for m in ("sync", "pipelined")]
    runs += [("aoti", "int8 quality", m) for m in ("sync", "pipelined")]
    for backend, tier, mode in runs:
        aoti, pipeline = backend == "aoti", mode == "pipelined"
        package, ref = ((os.path.join(set_dir, "model_psp"), quality_ref)
                        if tier == "model_psp" else (int8_package, int8_ref))
        if tier != "model_psp" and not pipeline:
            # native_check's run of the same frames, synchronous, taken
            # after every export had ended.
            short, got = tiers[tier]["cli_run"], None
        else:
            short = cli_run(host, package, frames[:NATIVE_RUNS[0]], aoti,
                            pipeline, keep=True)
            got = short.pop("out")
        if aoti:
            # The embedded-Python backend is checked, not timed here
            # (``run_native --python`` times it).
            long_run = cli_run(host, package, frames, aoti, pipeline)
            ms[tier, backend, mode] = {
                "outside": steady_ms(long_run["stamps"]),
                "quotient": quotient_ms(long_run, short),
                "cli": long_run["cli_s"] / len(frames) * 1e3,
                "head_s": (head_s(short["stamps"]),
                           head_s(long_run["stamps"]))}
        if got is None:
            continue
        if not aoti:
            exact = bool(np.array_equal(got, ref))
            log(f"native python {mode}: {NATIVE_CHECKED} frames bit for "
                f"bit with Engine.process: {exact}")
            if not exact:
                raise AssertionError("native: the embedded-Python "
                                     "backend differs from Engine")
            check[tier, backend, mode] = 0
        else:
            check[tier, backend, mode] = card_vs_cpu(
                f"native {tier} aoti {mode}", f"{NATIVE_CHECKED} frames",
                got, ref, against="Engine.process")
    seconds = time.perf_counter() - started
    int8_ms = int8["int8 quality"]["frame_ms"]
    for tier, e_ms in (("model_psp", engine_ms), ("int8 quality", int8_ms)):
        t = tiers[tier]
        floor = min(t["device_ms"], t["busy_ms"])
        log(f"native: ms a frame on {tier} through upscale_cli, the "
            f"{NATIVE_RUNS[1]}-frame run's steady interval from outside the "
            f"process (the CLI's own {NATIVE_RUNS[1]}- vs {NATIVE_RUNS[0]}"
            f"-frame quotient; its figure over the long run): " + ", ".join(
                f"{b} {m} {v['outside']:.3f} ({v['quotient']:.3f}; "
                f"{v['cli']:.3f}; first {NATIVE_RUNS[0]} frames of the two "
                f"runs {v['head_s'][0]:.3f} / {v['head_s'][1]:.3f} s)"
                for (n, b, m), v in ms.items() if n == tier)
            + f"; Engine.process median {e_ms:.3f} ms; artifact device "
            f"{t['device_ms']:.3f} ms a frame by CUDA events back to back "
            f"({t['host_gap_ms']:.3f} with host gaps), busy "
            f"{t['busy_ms']:.3f} in its trace")
        for mode in ("sync", "pipelined"):
            if ms[tier, "aoti", mode]["outside"] < floor:
                raise AssertionError(
                    f"native {tier}: the Python-free backend's {mode} ms a "
                    f"frame is below the artifact's device time a frame "
                    f"({floor:.3f}): the timing is at fault")
    log(f"native: phase {seconds:.1f} s")
    return {"host_s": host_s, "tiers": tiers, "wall_s": wall_s,
            "mean_flow": flow, "obs_diff": obs_diff, "ms": ms,
            "engine_ms": engine_ms, "int8_engine_ms": int8_ms,
            "max_diff": check, "refusal": refusal, "seconds": seconds}


def native_trace(name, step, model, k1_per_frame, dev_frame, device):
    """The artifact's trace (``run_native.trace_artifact``: K1 + K2 by
    kernel name, busy time by part) and its device time by CUDA events
    (``run_native.device_ms``)."""
    from joshupscale_torch.tools.run_native import device_ms, trace_artifact

    res = trace_artifact(name, step, model, k1_per_frame, dev_frame, device,
                         log)
    res.update(device_ms(step, model, dev_frame, device))
    log(f"native {name}: {res['device_ms']:.3f} ms a frame by CUDA events "
        f"back to back ({res['host_gap_ms']:.3f} with the host's launch "
        f"gaps), busy {res['busy_ms']:.3f} in the trace")
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
    from joshupscale_torch.runtime.engine import BUILD_STEPS, Engine

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
        f"({k1 / BUILD_STEPS:g} + {k2 / BUILD_STEPS:g} a "
        f"step)")
    if not same or (k1, k2) != (K1_PER_FRAME * BUILD_STEPS,
                                BUILD_STEPS):
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
    of the span, the device time by part (``profile_step.frame_profile``);
    the table and trace go to ``out_dir``."""
    from joshupscale_torch.tools.profile_step import frame_profile

    os.makedirs(out_dir, exist_ok=True)
    dev_frame = torch.from_numpy(frames[0][None]).to(device)
    prof, events, _ = replay_kernels(
        engine, dev_frame,
        trace_path=os.path.join(out_dir, f"trace_step_{name}.json"))
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(out_dir, f"profile_step_{name}.txt"), "w") as f:
        f.write(table)
    p = frame_profile(events, 3)
    log(f"{name} profile of 3 replayed frames: {p['ops']:.0f} device "
        f"ops/frame, device busy {p['busy_ms']:.3f} ms/frame of a "
        f"{p['window_ms']:.3f} ms/frame span (idle share "
        f"{p['idle_share']:.3f}, profiler on)")
    for key, ms in sorted(p["parts"].items(), key=lambda kv: -kv[1]):
        log(f"  {key}: {ms:.3f} ms/frame")
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
        params = seeded_params(built, seed)
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


def profile_fit(torch, setup, batches, seed, out_dir, step_ms):
    """``fit``'s profiler window on the card: 4 steps of ``setup`` (the
    full-width bf16 FRVSR setup ``phase_train`` timed) on ``batches``
    with ``profile_dir`` and a window of global steps 1..2; the trace it
    writes must hold CUDA kernel events.  The window's device events
    give the bf16 step's split (``device_split`` against ``step_ms``, a
    step timed on a batch already on the card), without its host copies:
    the stager's batches (host to device) and the metric reads (device
    to host) are ``fit``'s, not the step's.  Returns (kernel events,
    trace files, the split)."""
    import glob
    import itertools

    from joshupscale_torch.training.trainer import fit

    prof_dir = os.path.join(out_dir, "profile")
    fit(setup.step, setup.state, itertools.cycle(batches),
        epochs=1, steps_per_epoch=4,
        rng=torch.Generator(setup.device).manual_seed(seed),
        log_fn=lambda s: None, profile_dir=prof_dir, profile_batch=(1, 2))
    torch.cuda.synchronize()
    files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    events = []
    for path in files:
        with open(path) as f:
            events += [e for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") in
                       ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sum(1 for e in events if e["cat"] == "kernel")
    log(f"fit profiler window (global steps 1..2 of 4, flow 64x10, "
        f"generator 64x24, bf16): {len(files)} trace file(s) in "
        f"profile_dir, {kernels} CUDA kernel events")
    if len(files) != 1 or not kernels:
        raise AssertionError("fit's profiler window traced no CUDA kernel")
    host = [e for e in events if host_copy(e)]
    log(f"fit profiler window: {len(host)} host copies "
        f"({sum(e['dur'] for e in host) / 1e3:.2f} ms) left out of the "
        f"step's split")
    split = device_split("train (fit's window)", "bfloat16",
                         [e for e in events if not host_copy(e)], 2, step_ms,
                         log)
    return kernels, len(files), split


def bind_tools() -> None:
    """Bind the measurement tools' functions this script shares
    (``joshupscale_torch/tools/``) as its globals: ``main`` calls it once
    CUPTI's environment is set and torch is imported, an export process
    (``export_int8_tiers``) at its start."""
    global card_vs_cpu, cli_run, counted_session, device_split, host_copy
    global kernel_group, log_parts, profile_train, profiled, replay_kernels
    global repo_env, seeded_params
    from joshupscale_torch.tools.profile_step import (
        counted_session,
        kernel_group,
        log_parts,
        profiled,
        replay_kernels,
        seeded_params,
    )
    from joshupscale_torch.tools.profile_train_step import (
        device_split,
        host_copy,
        profile_train,
    )
    from joshupscale_torch.tools.run_native import (
        card_vs_cpu,
        cli_run,
        repo_env,
    )


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

    bind_tools()
    started = time.perf_counter()

    def mark(what):
        log(f"chip_smoke: {what} done at "
            f"{time.perf_counter() - started:.1f} s")

    device = resolve_device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_ops(also=[p.stem for p in _build.CSRC.glob("*.cu")])
    ops_build_s = time.perf_counter() - t0
    log(f"kernel and op library builds (nvcc for sm_90a, every source at "
        f"once, beside csrc/torch_ops.cpp against torch's headers): "
        f"{ops_build_s:.1f} s")
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
                            device, times["k2"][0], args.seed)
    del engine, built
    ps2 = phase_ps2(torch, args.seed, device, paths)
    variants = phase_variants(torch, args.seed, device, paths)
    int8 = phase_int8(torch, args.seed, device, paths)
    mark("serving paths, runtime, PS2 tiers, options, int8")
    batched = {}
    par = phase_parallel(torch, args.seed, device, batched)
    spatial = phase_spatial(torch, args.seed, device)
    k1_n2, lib_n2 = time_k1(torch, device, 64, n=2)
    mark("parallel, spatial, K1 at N = 2")
    with tempfile.TemporaryDirectory() as train_dir:
        train = phase_train(torch, args.seed, device, train_dir)
        gan = phase_gan(torch, args.seed, device, train_dir)
        tools = phase_tools(torch, args.seed, device, paths["quality"][0],
                            gan["setups"]["bfloat16"])
        life = phase_lifecycle(torch, args.seed, device, train_dir,
                               os.path.join(train_dir, "ckpt", "latest.npz"))
        doors = phase_doors(torch, args.seed, device, train_dir)
        mesh = phase_mesh(torch, args.seed, device, train_dir)
        mark("train, gan, lifecycle, doors, mesh")
        paths["trained export"] = (*train.pop("engine"), K1_PER_FRAME, 1)
        paths["gan export"] = (*gan.pop("engine"), K1_PER_FRAME, 1)
        paths["doors export"] = (*doors.pop("engine"), K1_PER_FRAME, 1)
        probes, p1_launches, p2_launches = phase_conv_probe(
            torch, device,
            (times["k1"]["conv_1"][0], times["k1"]["conv_2"][0]),
            times["lib_ms"])
        # Before phase_native: on an H100 with torch 2.11 (twice) the
        # replayed graphs' profiles lost 1-2 K1 records of 204 in every
        # session once the int8 artifacts had been loaded and profiled in
        # this process (recount_after_native looks again).
        after = phase_profiled(torch, paths, ps2, device, args.profile,
                               batched)
        mark("conv probe, profiled replays")
        nat = phase_native(torch, args.seed, device, train_dir, ops_build_s,
                           times["frame_ms"], int8, paths)
        mark("native")
    recount = recount_after_native(torch, "quality", *paths["quality"],
                                   device)
    # The training profiles reuse the setups and batches the training
    # phases timed; the bf16 FRVSR split comes from fit's window.
    step_ms = {n: {d: r[d]["step_ms"] for d in ("float32", "bfloat16")}
               for n, r in (("train", train), ("gan", gan))}
    train_setups = train.pop("setups")
    train_prof, _ = profile_train(
        {"float32": train_setups.pop("float32")}, train["batch"],
        args.seed, step_ms["train"], log=log)
    gan_prof, _ = profile_train(gan.pop("setups"), gan["batch"],
                                args.seed, step_ms["gan"], "gan", log=log)
    with tempfile.TemporaryDirectory() as fit_dir:
        fit_kernels, _, train_prof["bfloat16"] = profile_fit(
            torch, train_setups.pop("bfloat16"), train["batches"][:2],
            args.seed, fit_dir, step_ms["train"]["bfloat16"])
    mark("training profiles")
    paths.clear()
    batched.clear()

    (c1, p1, b1, by1), (c2, p2, b2, by2) = (times["k1"]["conv_1"],
                                            times["k1"]["conv_2"])
    k2_ms, k2_plain, k2_bound = times["k2"]
    k1_ms = (c1 + c2) / 2
    (d1, q1, e1, _), (d2, q2, e2, ey2) = (ps2["k1_c48"]["conv_1"],
                                          ps2["k1_c48"]["conv_2"])
    (f1, r1, g1, _), (f2, r2, g2, gy2) = (ps2["k1_c32"]["conv_1"],
                                          ps2["k1_c32"]["conv_2"])
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
               **{f"native {n} step.pt2 (trace)": t["launches"]
                  for n, t in nat["tiers"].items()},
               "gan play (one prediction, f32)": (gan["play_k1"], 0),
               "lifecycle drift_1000 (3 engines)": life["launches"],
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
         "c32": {"ms": (f1 + f2) / 2, "conv_1_ms": f1, "conv_2_ms": f2,
                 "plain_ms": (r1 + r2) / 2, "bound_ms": (g1 + g2) / 2,
                 "bound_by": gy2, "library_ms": ps2["lib_ms_c32"],
                 "max_abs_err": k1_err[32],
                 "share_of_bf16_peak": k1_flops(1, H, W, 32)
                 / ((f1 + f2) / 2 * 1e-3) / PEAK_BF16_FLOPS,
                 "fraction_of_bound": (g1 + g2) / (f1 + f2)},
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
    lat, cost = tools["latency"], tools["fit_cost"]
    log(f"tools: latency_probe quality over {TOOL_LATENCY_FRAMES} frames, "
        f"device p50 / p99 {lat['device']['p50_ms']:.3f} / "
        f"{lat['device']['p99_ms']:.3f} ms, Engine.process p50 / p99 "
        f"{lat['process']['p50_ms']:.3f} / {lat['process']['p99_ms']:.3f} "
        f"ms; serving_check stream vs clip max "
        f"{tools['serving_check']['stream_vs_clip_max']}; gather variants "
        f"warp / A / E {tools['gather']['warp_ms']:.3f} / "
        f"{tools['gather']['A_ms']:.3f} / {tools['gather']['E_ms']:.3f} ms; "
        f"fit_cost_probe ({TOOL_GAN_STEPS[0]} against {TOOL_GAN_STEPS[1]} "
        f"steps) " + ", ".join(
            f"{k} {v['ms_per_step']:.1f}" for k, v in cost.items())
        + f" ms a step; fit lag 0 / 1 " + " / ".join(
            f"{r['ms_per_step']:.1f}" for r in tools["fit_lags"])
        + f" ms a step; phase {tools['seconds']:.1f} s on {card}")
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
    u8 = life["drift"]["u8_state_vs_float"]
    log(f"lifecycle (the quality tools at full width, flow 64x10, generator "
        f"64x24): eval_synth on phase_train's checkpoint model / bilinear "
        f"{life['psnr'][0]:.2f} / {life['psnr'][1]:.2f} dB (CPU "
        f"{life['psnr_cpu'][0]:.2f} / {life['psnr_cpu'][1]:.2f}), zero-init "
        f"{life['zero_init'][0]:.2f} / {life['zero_init'][1]:.2f}, u8 state "
        f"{life['u8_state'][0]:.2f} / {life['u8_state'][1]:.2f}, ping-pong "
        f"{life['pingpong']:.3f} u8 steps; 270x480 model / bilinear "
        f"{life['fullres'][0]:.2f} / {life['fullres'][1]:.2f} dB; "
        f"bn_recalibrate set {life['bn_changed']} moving statistics; "
        f"drift_1000 in {life['drift_s']:.1f} s: u8 state vs float mean "
        f"{u8['mean_u8_steps_overall']:.4f}, pooled p99 "
        f"{u8['p99_u8_steps_overall']}, max {u8['max_u8_steps_overall']}, "
        f"stream vs clip max "
        f"{max(life['drift']['stream_vs_clip_max_u8'].values())}; phase "
        f"{life['seconds']:.1f} s on {card}")
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
    for n, t in nat["tiers"].items():
        is_int8 = "int_mm" in t
        log(f"native {n} (270x480 bf16, written by "
            f"{'export_int8_tiers' if is_int8 else 'make_model_set'}): "
            f"step.pt2 {t['size_mb']:.1f} MiB compiled in "
            f"{t['compile_s']:.1f} s; {t['launches'][0]} K1 + "
            f"{t['launches'][1]} K2 in the artifact"
            + (f", {t['int_mm']} aten._int_mm nodes (= quantized convs), "
               f"{t['int8_gemms']} int8 products in the trace"
               if is_int8 else "")
            + f"; device {t['device_ms']:.3f} ms a frame by CUDA events, "
            f"busy {t['busy_ms']:.3f} in the trace ("
            + ", ".join(f"{g} {v:.3f}" for g, v in sorted(
                t["parts"].items(), key=lambda kv: -kv[1]))
            + f"); against Engine: in process u8 max {t['step_diff'][0]}, "
            f"state max {t['step_diff'][1]:.3f} u8 steps, upscale_cli aoti "
            f"u8 max {t['cli_diff']}"
            + (f"; mean |flow| {nat['mean_flow']:.3f} px"
               if n == "model_psp_fast" else "") + f" on {card}")
    walls = nat["wall_s"]
    log(f"native (host build {nat['host_s']:.1f} s; model set written in "
        f"{max(walls[k] for k in NATIVE_SET_PROCESSES):.1f} s, int8 tiers "
        f"in {max(walls[k] for k in NATIVE_INT8_PROCESSES):.1f} s, all four "
        f"processes side by side): ms a frame through upscale_cli: "
        + "; ".join(
            f"{t} {b} {m} {v['outside']:.3f} (the CLI's quotient "
            f"{v['quotient']:.3f})" for (t, b, m), v in nat["ms"].items())
        + f"; beside Engine.process {nat['engine_ms']:.3f} (model_psp), "
        f"{nat['int8_engine_ms']:.3f} (int8 quality) and the artifacts' "
        f"device time {nat['tiers']['model_psp']['device_ms']:.3f}, "
        f"{nat['tiers']['int8 quality']['device_ms']:.3f}; aoti u8 max "
        f"{max(nat['max_diff'].values())} against Engine; fake OBS host "
        f"over the set u8 max {nat['obs_diff']}; embedded Python refuses "
        f"int8: {nat['refusal']}; phase {nat['seconds']:.1f} s on {card}")
    log(f"quality after phase_native: replays counted {recount[0]:g} K1 + "
        f"{recount[1]:g} K2 a step in one profiler session "
        f"(informational; phase_profiled's check ran before) on {card}")
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
