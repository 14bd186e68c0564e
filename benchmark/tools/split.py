"""A traced run of a cell, each call split by the program's own spans
and stage markers (``benchlib/calls.py``).

    python3 benchmark/tools/split.py --workload <cell> --seed <n> \\
        [--seconds 10] [--cpu]

The cell runs as ``run.py --trace 1`` runs it (``runner.run_cell``); the
traced stretch is kept and one JSON line is printed:

- ``metrics``, ``device``, ``breakdown``: the run's result line's;
- ``call`` (ms a call, means over the whole calls of
  ``benchlib/calls.py``): the harness's call span, and its parts in
  order: ``launch`` (``engine.process``'s start to the end of
  ``engine.replay``), ``to_first_kernel`` (the replay's end to the
  call's first kernel), ``kernels`` (first kernel's start to the last
  one's end), ``readback`` (the last kernel's end to the end of
  ``engine.readback``) and ``rest`` (the call span less those);
- ``launch_parts`` (ms a call): ``before_replay`` (``engine.process``'s
  start to ``engine.replay``'s: the checks, the staging and the input
  copy's enqueue, which the profiler slows little) and ``replay`` (the
  graph launch, which it slows most);
- ``step`` (ms a frame): the three stages, ``after_generator`` (the
  kernels after the generator marker: the state commit and K2) and
  ``markers`` (the markers' own time), with ``sum`` against
  ``step.busy_ms``;
- ``host``: µs a call inside ``engine.process`` that no sub-span
  covers, and its share of the call;
- ``dropped``: the calls that are not whole (``calls.Call.whole``), and
  for at most 5 of them how far (µs) their first card record starts
  before the input copy's span and their last one ends after the
  readback's;
- ``gaps``: the idle gaps over 0.2 ms inside calls, longest first (at
  most 10): µs, the harness's label, and the ``engine.*`` spans open.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path[:0] = [str(HERE.parent), str(ROOT)]


def split(tr, metrics: dict) -> dict:
    from benchlib.calls import (
        H2D,
        MARKERS,
        PROCESS,
        READBACK,
        REPLAY,
        SUB_SPANS,
        calls,
        mean,
    )

    per_call, before, step, host = [], [], [], []
    streams = tr.frames / tr.calls
    for c in calls(tr):
        p0, r0, r1 = (c.first_start(PROCESS), c.first_start(REPLAY),
                      c.last_end(REPLAY))
        b1, k1 = c.last_end(READBACK), c.kernel_end()
        starts = [e["ts"] for e in c.kernels] + [
            e["ts"] for e in c.markers.values()]
        k0 = min(starts) if starts else None
        call = c.end - c.start
        if None not in (p0, r0, r1, b1, k0, k1):
            per_call.append([call, r1 - p0, k0 - r1, k1 - k0, b1 - k1,
                             call - (b1 - p0)])
            before.append((r0 - p0, r1 - r0))
        gen = c.markers.get(MARKERS[2])
        if gen is not None:
            step.append((c.busy_between(gen["ts"] + gen["dur"], c.end),
                         sum(e["dur"] for e in c.markers.values())))
        for p in c.spans.get(PROCESS, []):
            lo, hi = p["ts"], p["ts"] + p["dur"]
            subs = sum(e["dur"] for n in SUB_SPANS for e in c.spans.get(n, [])
                       if lo <= e["ts"] < hi)
            host.append((p["dur"] - subs, (p["dur"] - subs) / p["dur"]))
    names = ("span", "launch", "to_first_kernel", "kernels", "readback",
             "rest")
    out = {"call": {n: mean(v[i] / 1e3 for v in per_call)
                    for i, n in enumerate(names)} if per_call else None}
    if before:
        out["launch_parts"] = {"before_replay": mean(b for b, _ in before)
                               / 1e3,
                               "replay": mean(r for _, r in before) / 1e3}
    value = lambda n: metrics.get(n, {}).get("value")  # noqa: E731
    if step:
        stages = {n: value(n) for n in ("stage.flow_ms", "stage.warp_ms",
                                         "stage.generator_ms")}
        after = mean(a for a, _ in step) / 1e3 / streams
        marks = mean(m for _, m in step) / 1e3 / streams
        total = (sum(v for v in stages.values() if v is not None)
                 + after + marks)
        out["step"] = dict(stages, after_generator=after, markers=marks,
                           sum=total, busy=value("step.busy_ms"))
    if host:
        out["host"] = {"uncovered_us": mean(u for u, _ in host),
                       "uncovered_share": mean(s for _, s in host)}
    dropped = [c for c in calls(tr, every=True) if not c.whole]
    offsets = []
    for c in dropped[:5]:
        records = c.kernels + list(c.markers.values()) + c.copies
        lo = c.first_start(H2D)
        hi = c.last_end(READBACK)
        offsets.append([
            None if lo is None or not records
            else lo - min(e["ts"] for e in records),
            None if hi is None or not records
            else max(e["ts"] + e["dur"] for e in records) - hi])
    out["dropped"] = {"calls": len(dropped), "of": tr.calls,
                      "offsets_us": offsets}
    gaps = []
    for at, length in tr.idle_gaps():
        mid = at + length / 2
        if length <= 200 or not any(s["ts"] <= at and at + length <= s["ts"]
                                    + s["dur"] for s in tr.spans):
            continue
        open_ = sorted((e for e in tr.host if e["name"].startswith("engine.")
                        and e["ts"] <= mid < e["ts"] + e["dur"]),
                       key=lambda e: e["ts"])
        gaps.append([length, tr.label(mid), [e["name"] for e in open_]])
        if len(gaps) == 10:
            break
    out["gaps"] = gaps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose files name the cell")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (numbers of no device)")
    args = ap.parse_args(argv)

    from run import cache_env

    from benchlib.trace import CUPTI_ENV
    os.environ.update(cache_env(ROOT))
    os.environ.update(CUPTI_ENV)
    import torch

    from benchlib.runner import run_cell
    from benchlib.spec import load_cell

    if args.cpu:
        device, kind = "cpu", "cpu"
    elif not torch.cuda.is_available():
        print("split: no CUDA device", file=sys.stderr)
        return 2
    else:
        device, kind = "cuda:0", torch.cuda.get_device_name(0)
    cell = load_cell(Path(args.root), args.workload)
    kept = {}

    def keep(trace, ctx):  # a reader that keeps the traced stretch
        kept["trace"] = trace

    cell.per_layer["split.keep"] = SimpleNamespace(read=keep, unit="")
    res = run_cell(cell, args.seed, args.seconds, True, device,
                   time.monotonic(), kind=kind)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": res["correct"], "metrics": res["metrics"],
           "device": res["device"], "breakdown": res["breakdown"]}
    out.update(split(kept["trace"], res["metrics"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
