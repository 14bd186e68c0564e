"""One run of one cell: set-up, the closed-loop window, the traced
stretch, the check.

Set-up builds the configuration through the program's registry
(``create_models``), replaces every weight with the seed's
(``weights.seeded_params``, on the device), makes the mix's frames
(``traffic.make_ring``), builds the entry the mix names (``Engine``, or
``ShardedEngine`` on the one device for several streams; each captures
its frame graph), serves ``warmup_calls`` calls and resets the streams.
The window then calls the entry in a closed loop, the next call as soon
as the last returns, resetting the streams at each shot's first frame,
until ``seconds`` have passed; each call's latency is the host clock
around it (the frames handed in, the step, the display frames in host
memory).  Calls after the close that the check still needs are served
untimed.  With ``trace`` the window's first ``trace_calls`` calls are a
profiler session (``trace.profile_stretch``) and the run reports the
per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from benchlib import check, flops, stats, trace as tracing
from benchlib.spec import Cell
from benchlib.traffic import make_ring
from benchlib.weights import clone, seeded_params


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def program(cell: Cell):
    """The configuration through the program's registry: the serving
    model and its raw param tree (whose values the seed replaces)."""
    from joshupscale_torch.models.registry import create_models, strip_meta

    built = create_models(cell.config["models"], seed=0)["inference"]
    return built.obj, strip_meta(built.params)


def build_system(cell: Cell, model, params, device):
    """The program's entry that the mix names, built on ``params``."""
    from joshupscale_torch.parallel.serving import ShardedEngine
    from joshupscale_torch.runtime.engine import Engine

    mix = cell.traffic
    if mix["entry"] == "engine":
        return Engine(model, params, device=device)
    if mix["entry"] == "sharded":
        return ShardedEngine(model, params, devices=[device],
                             streams_per_device=int(mix["streams"]))
    raise ValueError(f"unknown entry {mix['entry']!r}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, system_factory: Optional[Callable] = None,
             kind: str = "cpu") -> dict:
    """The result of one run (the line ``run.py`` prints, without the
    import check).  ``system_factory(cell, model, params, device)``
    builds the system under test (default ``build_system``); ``kind``
    names the device for ``device.kind``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    mix, models = cell.traffic, cell.config["models"]
    inf = models["inference"]
    h, w = inf["frame_height"], inf["frame_width"]
    streams, shot = int(mix["streams"]), int(mix["shot_frames"])
    pan_hr = [4 * v for v in mix["pan_lr_px_per_frame"]]

    model, template = program(cell)
    params = seeded_params(template, models, cell.config["weights"], pan_hr,
                           seed, device)
    ring = make_ring(mix, seed, h, w, device)
    r = len(ring)
    frames = ring if streams > 1 else ring[:, 0]
    kept = check.kept_calls(mix, seed)
    # Written now, so that no page of it is first touched in the window.
    served = np.full((len(kept), streams, 4 * h, 4 * w, 3), 0, np.uint8)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    system = (system_factory or build_system)(cell, model, clone(params),
                                              device)
    call, reset = system.process, system.reset
    for i in range(int(mix["warmup_calls"])):
        call(frames[(r - 1 - i) % r])
    reset()
    sync()
    setup_s = time.monotonic() - t_start

    lat = []
    state = {"i": 0}

    def span(name: str, traced: bool):
        return torch.profiler.record_function(name) if traced else (
            contextlib.nullcontext())

    def step(traced: bool = False) -> float:
        i = state["i"]
        if i and i % shot == 0:
            with span(tracing.LOOP_SPAN, traced):
                reset()
        frame = frames[i % r]
        with span(tracing.CALL_SPAN, traced):
            t0 = time.perf_counter()
            out = call(frame)
            t1 = time.perf_counter()
        slot = kept.get(i)
        if slot is not None:
            served[slot] = out.reshape(served.shape[1:])
        state["i"] = i + 1
        return t1 - t0

    per_layer, trace_device, breakdown = None, {}, None
    w0 = time.perf_counter()
    if trace:
        expected = flops.resblock_convs(models, streams)
        k1 = len(expected)

        def whole(t: tracing.Trace) -> bool:
            return not cuda or (t.count(tracing.K1) == k1 * t.calls
                                and t.count(tracing.K2) >= t.calls)

        tr = tracing.profile_stretch(
            lambda: lat.append(step()), lambda j: lat.append(step(True)),
            int(mix["trace_calls"]), sync, not cuda, streams, whole, log)
        ctx = {"models": models, "streams": streams,
               "peaks": flops.peaks_for(kind),
               "dtype": inf.get("compute_dtype", "float32"),
               "flops_per_frame": flops.model_flops_per_frame(models),
               "resblock_convs": expected}
        log(f"trace: {tr.calls} calls, {tr.frames} frames, "
            f"{len(tr.device)} device records, "
            f"{tr.count(tracing.K1)} res-block conv launches "
            f"({tr.count(tracing.K1) / tr.calls:g} a call, "
            f"{k1} res-block convs a step), window "
            f"{tr.window_us / 1e3:.3f} ms")
        per_layer = {}
        for name, module in cell.per_layer.items():
            value = module.read(tr, ctx)
            if value is not None:
                per_layer[name] = {"value": value, "unit": module.unit}
        trace_device = {"busy_s": tr.busy_us() / 1e6,
                        "window_s": tr.window_us / 1e6}
        breakdown = tr.breakdown()
    while True:
        lat.append(step())
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    calls = state["i"]
    while state["i"] <= max(kept):  # answers the check waits for
        step()
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    del system, call, reset
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, notes = check.compare(cell.reference, models, params, ring,
                                   mix, kept, served, device)
    correct, compared = check.judge(numbers, cell.limits)
    per_limit = cell.limits["worst_frame_mean_abs_u8"]["limit"]
    failed = sum(1 for v in notes["per_frame"] if v > per_limit)
    log(f"check: {notes['frames_compared']} frames compared over "
        f"{notes['reference_steps']} reference steps; mean |flow| "
        f"{notes['mean_abs_flow_lr_px']:.4f} LR px a frame; reference "
        f"{notes['reference_s']:.3f} s")

    if trace:
        metrics = per_layer
    else:
        metrics = stats.end_to_end(lat[:calls], streams, window_s, setup_s)
        wanted = {m["name"] for m in cell.end_to_end}
        metrics = {k: v for k, v in metrics.items() if k in wanted}
        log(f"window: {calls} calls, {calls * streams} frames in "
            f"{window_s:.4f} s; latency p50 "
            f"{stats.percentile(lat[:calls], 50) * 1e3:.4f} ms")
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak), **trace_device}
    result = {"correct": bool(correct), "attempted": calls * streams,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        log(f"compared {k} {v!r} limit {lim!r}")
    return result
