"""The traced stretch call by call, with what the program marks in it:
the serving engine's ``engine.*`` host spans
(``joshupscale_torch/runtime/spans.py``) and the frame graph's
``stage_end_*`` marker kernels (``joshupscale_torch/kernels/markers.py``,
launched only while a profiler session is active).

Everything is read from a ``trace.Trace`` as it stands (``spans``,
``host``, ``device``).  A program that makes no such span or marker, or
a rehearsal on the CPU (whose device records are the host's ATen ops),
gives nothing: the readers of these metrics then return None.

A call counts only if it holds its own card records and no other
call's: where it copies a frame in (an ``engine.h2d`` span) its first
card record is a copy to the card, none of its records ends after its
last ``engine.readback`` span ends (the blocking copy out waits for
them), and its markers, if any, come once each and in stage order.  A
call that breaks this lost records to a neighbour or holds some of a
neighbour's, as when the trace sets the card's clock off against the
host's by more than the call's margins (seen once on an H100: every
kernel ended within 4 µs of the readback's end, where the copy out alone
takes 0.45 ms); every reader leaves it out.  A smaller offset moves no
record across calls and is not seen: it shifts ``engine.readback_ms``
by its size (the copy in started up to 64 µs before its span in two of
six runs on an H100).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from benchlib.trace import clipped, union

PROCESS, H2D, REPLAY, READBACK = ("engine.process", "engine.h2d",
                                  "engine.replay", "engine.readback")
SUB_SPANS = ("engine.stage_wait", "engine.stage_copy", H2D, REPLAY,
             READBACK)
MARKERS = ("stage_end_flow", "stage_end_warp", "stage_end_generator")


class Call:
    """One call: its ``bench.call`` span, the ``engine.*`` host records
    that start inside it by name (in order of start), and the card's
    records that start inside it: ``kernels`` (the markers apart, by
    name in ``markers``) and ``copies``.  ``whole``: the call holds
    only its own records (the module's test)."""

    def __init__(self, span: dict, host: List[dict], device: List[dict]):
        self.start = span["ts"]
        self.end = span["ts"] + span["dur"]
        self.spans: Dict[str, List[dict]] = {}
        for e in host:
            if e["name"].startswith("engine."):
                self.spans.setdefault(e["name"], []).append(e)
        kernels = [e for e in device if e["kind"] == "kernel"]
        marks = [e for e in kernels if e["name"] in MARKERS]
        names = [e["name"] for e in marks]
        self.markers = {e["name"]: e for e in marks}
        self.kernels = [e for e in kernels if e["name"] not in MARKERS]
        self.copies = [e for e in device if e["kind"] != "kernel"]
        hi = self.last_end(READBACK)
        self.whole = (
            len(set(names)) == len(names)
            and names == sorted(names, key=MARKERS.index)
            and (H2D not in self.spans or not device
                 or device[0]["name"].startswith("Memcpy HtoD"))
            and (hi is None or all(e["ts"] + e["dur"] <= hi for e in device)))

    def first_start(self, name: str) -> Optional[float]:
        found = self.spans.get(name)
        return found[0]["ts"] if found else None

    def last_end(self, name: str) -> Optional[float]:
        found = self.spans.get(name)
        return max(e["ts"] + e["dur"] for e in found) if found else None

    def kernel_end(self) -> Optional[float]:
        """The end of the call's last kernel (markers included)."""
        ends = [e["ts"] + e["dur"] for e in self.kernels]
        ends += [e["ts"] + e["dur"] for e in self.markers.values()]
        return max(ends) if ends else None

    def busy_between(self, lo: float, hi: float) -> float:
        """Busy µs of the call's kernels (markers left out) in
        ``[lo, hi]``."""
        return clipped(union([(e["ts"], e["ts"] + e["dur"])
                              for e in self.kernels]), lo, hi)


def calls(trace, every: bool = False) -> List[Call]:
    """The counted calls in order: the whole ones (``Call.whole``), or
    ``every`` one."""
    host = sorted(trace.host, key=lambda e: e["ts"])
    device = sorted((e for e in trace.device
                     if not e["name"].startswith("aten::")),
                    key=lambda e: e["ts"])
    host_ts, device_ts = [e["ts"] for e in host], [e["ts"] for e in device]

    def inside(records, starts, lo, hi):
        return records[bisect.bisect_left(starts, lo):
                       bisect.bisect_left(starts, hi)]

    found = [Call(s, inside(host, host_ts, s["ts"], s["ts"] + s["dur"]),
                  inside(device, device_ts, s["ts"], s["ts"] + s["dur"]))
             for s in trace.spans]
    return found if every else [c for c in found if c.whole]


def mean(values) -> Optional[float]:
    """The mean of the values that are not None (None if there are
    none)."""
    found = [v for v in values if v is not None]
    return sum(found) / len(found) if found else None


def stage_ms(trace, after: Optional[str], before: str) -> Optional[float]:
    """Kernel ms a frame between the end of marker ``after`` (the call's
    start if None) and the start of marker ``before``, over the calls
    that hold both markers."""
    per_call = []
    for c in calls(trace):
        if before not in c.markers or (after and after not in c.markers):
            continue
        lo = c.start if after is None else (
            c.markers[after]["ts"] + c.markers[after]["dur"])
        per_call.append(c.busy_between(lo, c.markers[before]["ts"]))
    if not per_call:
        return None
    streams = trace.frames / trace.calls
    return sum(per_call) / len(per_call) / streams / 1e3
