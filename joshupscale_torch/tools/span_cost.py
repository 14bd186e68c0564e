"""What the serving engine's tracing costs (``runtime/spans.py``,
``kernels/markers.py``).

- ``span()`` with no profiler session (the shared no-op) and inside one
  (a profiler record): host µs a span over ``--spans`` spans;
- ``Engine.process`` with the profiler off (the plain frame graph): host
  ms a call over ``--frames`` calls, mean and p50, and the device ms of
  a replay over as many steps back to back; and the host µs of
  enqueueing one replay (``Engine.step`` on a device frame, no wait),
  with the profiler off and inside a session (the marked graph);
- the marked frame graph: the seconds and device bytes (allocated and
  reserved by the caching allocator) of its capture, which the engine
  makes with the plain graph's, and the markers' device µs a frame,
  over a profiled stretch of ``--traced`` calls (warmed as the
  benchmark warms its session).  The host time inside
  ``engine.process`` that no sub-span covers is the benchmark's
  ``tools/split.py``'s.

The tier is the quality architecture at 270 x 480 (or ``--config``, a
tier YAML), seeded weights, as ``tools/profile_step.py`` builds it.

    python -m joshupscale_torch.tools.span_cost [--config PATH] \\
        [--frames 300] [--traced 50] [--process-only] [--cpu --tiny]

``--process-only`` times ``Engine.process`` alone: it uses nothing but
the engine, so run from another checkout's root (that checkout first on
``PYTHONPATH``) it times that checkout's engine for an A/B.  ``--cpu``
rehearses on the CPU (no graph, no marker; numbers labelled ``cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

def process_ms(engine, frames, n: int, cpu: bool) -> dict:
    """Host ms of ``n`` ``Engine.process`` calls (after 20 untimed) and,
    on the card, the device ms of one replay: ``n`` steps back to back
    between two CUDA events (the enqueue is far shorter than a step)."""
    for i in range(20):
        engine.process(frames[i % len(frames)])
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        engine.process(frames[i % len(frames)])
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"mean": float(np.mean(times)), "p50": float(np.median(times))}
    if not cpu:
        frame = torch.from_numpy(frames[:1]).to(engine.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            engine.step(frame)
        end.record()
        end.synchronize()
        out["replay_device_ms"] = start.elapsed_time(end) / n
    return out


def enqueue_us(engine, frame, n: int, cpu: bool) -> dict:
    """Host µs of ``engine.step(frame)`` (a replay's enqueue; the card
    drained before each), with the profiler off and on."""
    from torch.profiler import ProfilerActivity, profile

    sync = (lambda: None) if cpu else torch.cuda.synchronize

    def loop():
        times = []
        for _ in range(n):
            sync()
            t0 = time.perf_counter()
            engine.step(frame)
            times.append(time.perf_counter() - t0)
        sync()
        return float(np.median(times)) * 1e6

    off = loop()
    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts):
        on = loop()
    return {"off_p50": off, "on_p50": on}


def span_us(n: int, cpu: bool) -> dict:
    """Host µs a ``with span(...)`` with the profiler off and on."""
    from torch.profiler import ProfilerActivity, profile

    from joshupscale_torch.runtime.spans import span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("engine.span_cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    def bare():
        t0 = time.perf_counter()
        for _ in range(n):
            with contextlib.nullcontext():
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off, base = loop(), bare()
    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts):
        on = loop()
    return {"off": off, "on": on, "empty_with": base}


def capture_cost(engine, cpu: bool) -> dict:
    """The marked frame graph's capture, made once more beside the
    engine's own (before any profiler session): its seconds and the
    device bytes it adds (allocated and reserved by the caching
    allocator).  Nothing on the CPU (no graph)."""
    if cpu:
        return {"capture_s": 0.0, "allocated_bytes": 0, "reserved_bytes": 0}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    kept = engine._marked
    t0 = time.perf_counter()
    engine._capture_marked()
    torch.cuda.synchronize()
    out = {"capture_s": time.perf_counter() - t0,
           "allocated_bytes": torch.cuda.memory_allocated() - before[0],
           "reserved_bytes": torch.cuda.memory_reserved() - before[1]}
    engine._marked = kept
    return out


def marker_us(engine, frames, n: int, cpu: bool) -> float:
    """The markers' device µs a frame over a profiled stretch: one call,
    50 ms idle, then ``n`` counted calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from joshupscale_torch.kernels.markers import MARKERS

    sync = (lambda: None) if cpu else torch.cuda.synchronize
    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        engine.process(frames[0])
        sync()
        time.sleep(0.05)
        with record_function("span_cost.counted"):
            for i in range(n):
                engine.process(frames[i % len(frames)])
            sync()
    events = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
               e.device_type() == DeviceType.CPU)
              for e in prof.profiler.kineto_results.events()]
    counted = [e for e in events if e[0] == "span_cost.counted" and e[3]][0]
    lo, hi = counted[1], counted[1] + counted[2]
    return sum(e[2] for e in events if lo <= e[1] < hi and not e[3]
               and e[0] in MARKERS) / n


def main(argv=None) -> int:
    from joshupscale_torch.tools.profile_step import TINY, build_step
    from joshupscale_torch.tools.timing import card_line, tool_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="serving-tier YAML (default: quality arch)")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--traced", type=int, default=50)
    ap.add_argument("--spans", type=int, default=100000)
    ap.add_argument("--process-only", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="32x48 frames, 1 res block a net")
    args = ap.parse_args(argv)

    device = tool_device(args.cpu, "span_cost")
    h, w = TINY if args.tiny else (270, 480)
    engine, _ = build_step(h, w, "bfloat16", args.config, device,
                           blocks=1 if args.tiny else None)
    frames = np.random.default_rng(0).integers(0, 256, (8, h, w, 3),
                                               np.uint8)
    out = {"device": "cpu" if args.cpu else card_line(),
           "config": args.config or "quality",
           "process_ms": process_ms(engine, frames, args.frames, args.cpu)}
    if not args.process_only:
        out["marked"] = capture_cost(engine, args.cpu)
        out["span_us"] = span_us(args.spans, args.cpu)
        out["marked"]["marker_us_a_frame"] = marker_us(
            engine, frames, args.traced, args.cpu)
        out["replay_enqueue_us"] = enqueue_us(
            engine, torch.from_numpy(frames[:1]).to(device), args.traced,
            args.cpu)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
