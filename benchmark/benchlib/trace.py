"""The traced stretch: a ``torch.profiler`` session over some calls of
the window, reduced to device records, the harness's host spans and the
idle gaps between device records.

The session is warmed up as the port's ``tools/profile_step.py``
``warm_session`` does: one call, the card idle ``GAP_S``, then the
counted calls, each inside a ``bench.call`` span (the rest of the loop's
body inside ``bench.loop``).  On an H100 with torch 2.11 a session's
first call could lose the records of its first kernels; the calls after
the gap kept all of theirs.  A session whose counted calls do not all
hold the kernels the configuration makes is run again, up to
``SESSIONS`` times (``tools/profile_step.py`` ``counted_session``).
Kineto's CUPTI is kept attached between sessions (``CUPTI_ENV``, set
before torch is imported), as PyTorch does for its own graph profiling.
No trace file is written.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

CUPTI_ENV = {"DISABLE_CUPTI_LAZY_REINIT": "1", "TEARDOWN_CUPTI": "0"}
GAP_S = 0.05
SESSIONS = 3
CALL_SPAN, LOOP_SPAN = "bench.call", "bench.loop"
K1, K2 = "K1 resblock_conv3x3", "K2 d2s_display_u8"


def kernel_group(name: str) -> str:
    """The part of a step a CUDA kernel belongs to, by its name (the
    port's ``tools/profile_step.py`` ``kernel_group``)."""
    low = name.lower()
    if name.startswith("triton_"):
        return "inductor (fused Triton)"
    if "conv3x3" in name:
        return K1
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
    if name.startswith("Memcpy"):
        return "copies (" + name.split(" ")[1] + ")"
    if name.startswith("Memset"):
        return "memset"
    return "other elementwise"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clipped(intervals, lo: float, hi: float) -> float:
    """The length of ``intervals`` (disjoint) inside ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


class Trace:
    """A traced stretch of ``calls`` calls of ``streams`` frames each.

    ``device``: the card's records (``name``, ``ts``, ``dur`` in µs,
    ``kind`` kernel / memcpy / memset) inside the stretch; ``spans``: the
    ``bench.call`` spans of the counted calls; ``host``: every host
    record (spans, ATen ops, CUDA runtime calls) inside the stretch;
    ``t0``, ``t1``: the first counted call's start and the last one's end.
    """

    def __init__(self, device, spans, host, streams: int):
        self.spans = sorted(spans, key=lambda e: e["ts"])
        self.t0 = self.spans[0]["ts"]
        self.t1 = max(s["ts"] + s["dur"] for s in self.spans)
        self.device = [e for e in device
                       if self.t0 <= e["ts"] < self.t1]
        self.host = [e for e in host
                     if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.calls = len(self.spans)
        self.frames = self.calls * streams

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self, kinds=("kernel", "memcpy", "memset")):
        """Disjoint busy intervals of the records of ``kinds``."""
        return union([(e["ts"], e["ts"] + e["dur"]) for e in self.device
                      if e["kind"] in kinds])

    def busy_us(self, kinds=("kernel", "memcpy", "memset")) -> float:
        return clipped(self.busy(kinds), self.t0, self.t1)

    def parts_ms(self, kinds=("kernel",),
                 group: Callable[[str], str] = kernel_group
                 ) -> Dict[str, float]:
        """Busy ms of the stretch by ``group(name)`` (``kernel_group`` by
        default): each record counts from the later of its start and the
        end of every record that started before it (the port's
        ``timing.busy_parts``), so the parts sum to the busy time."""
        parts: Dict[str, float] = {}
        end = float("-inf")
        for e in sorted(self.device, key=lambda e: e["ts"]):
            if e["kind"] not in kinds:
                continue
            start, stop = e["ts"], e["ts"] + e["dur"]
            key = group(e["name"])
            parts[key] = parts.get(key, 0.0) + max(
                0.0, stop - max(start, end)) / 1e3
            end = max(end, stop)
        return parts

    def count(self, group: str) -> int:
        return sum(1 for e in self.device if e["kind"] == "kernel"
                   and kernel_group(e["name"]) == group)

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, length) µs of the stretch's idle gaps, longest first."""
        gaps, at = [], self.t0
        for s, e in self.busy():
            if s > at:
                gaps.append((at, min(s, self.t1) - at))
            at = max(at, e)
            if at >= self.t1:
                break
        if at < self.t1:
            gaps.append((at, self.t1 - at))
        return sorted(gaps, key=lambda g: -g[1])

    def label(self, ts: float) -> str:
        """What the host was doing at ``ts``: the harness span open then
        and the innermost host record inside it."""
        open_ = [e for e in self.host if e["ts"] <= ts < e["ts"] + e["dur"]]
        span = [e["name"] for e in open_ if e["name"] in (CALL_SPAN,
                                                           LOOP_SPAN)]
        inner = [e for e in open_ if e["name"] not in (CALL_SPAN, LOOP_SPAN)]
        where = span[0] if span else "between calls"
        if inner:
            where += " > " + max(inner, key=lambda e: e["ts"])["name"]
        return where

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by part, seconds)
        and the longest idle gaps labelled by what the host did."""
        parts = self.parts_ms(("kernel", "memcpy", "memset"))
        ops = sorted(parts.items(), key=lambda kv: -kv[1])[:top]
        gaps = [[self.label(s + d / 2), d / 1e6]
                for s, d in self.idle_gaps()[:top]]
        return {"device_ops": [[k, v / 1e3] for k, v in ops],
                "idle_gaps": gaps}


DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}


def _kind(event) -> Optional[str]:
    """kernel, memcpy or memset for the card's records of work; None for
    its other records (the host spans mirrored on the card's timeline,
    synchronisations)."""
    activity = getattr(event, "activity_type", None)
    if activity is not None:
        return DEVICE_KINDS.get(str(activity()))
    name = event.name()
    if name in (CALL_SPAN, LOOP_SPAN) or "Sync" in name or "Wait" in name:
        return None
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def profile_stretch(warm: Callable[[], None], counted: Callable[[int], None],
                    calls: int, sync: Callable[[], None], cpu: bool,
                    streams: int,
                    expected: Optional[Callable[["Trace"], bool]] = None,
                    log=print) -> Trace:
    """A warmed session (``warm()``, idle ``GAP_S``, ``counted(j)`` for
    each of ``calls`` calls, which opens its own spans) as a ``Trace``;
    sessions whose trace fails ``expected`` are run again.  ``cpu``: a
    rehearsal on the CPU, whose ATen records stand in for the card's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    for session in range(1, SESSIONS + 1):
        sync()
        with profile(activities=acts) as prof:
            warm()
            sync()
            time.sleep(GAP_S)
            for j in range(calls):
                counted(j)
            sync()
        device, host, spans = [], [], []
        for e in prof.profiler.kineto_results.events():
            rec = {"name": e.name(), "ts": e.start_ns() / 1e3,
                   "dur": e.duration_ns() / 1e3}
            if e.device_type() == DeviceType.CPU:
                host.append(rec)
                if rec["name"] == CALL_SPAN:
                    spans.append(rec)
                if cpu and rec["name"].startswith("aten::"):
                    device.append(dict(rec, kind="kernel"))
            elif _kind(e) is not None:
                device.append(dict(rec, kind=_kind(e)))
        spans = sorted(spans, key=lambda e: e["ts"])[-calls:]
        if len(spans) != calls:
            raise RuntimeError(f"the profiler kept {len(spans)} of "
                               f"{calls} call spans")
        trace = Trace(device, spans, host, streams)
        if expected is None or expected(trace):
            return trace
        log(f"trace: profiler session {session} of {SESSIONS} lost "
            f"kernel records ({trace.count(K1)} K1, {trace.count(K2)} K2 "
            f"over {calls} calls); tracing again")
    raise RuntimeError(f"no profiler session of {SESSIONS} kept every "
                       f"kernel record")
