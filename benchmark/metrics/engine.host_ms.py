"""Host ms a call outside the card's work: each traced call's span (the
harness's host clock around the entry's ``process``) less the device
time (kernels and copies) inside it, the mean over the calls."""

from benchlib.trace import clipped

name = "engine.host_ms"
unit = "ms"
layer = "serving I/O (runtime/engine.py ServingIO, parallel/serving.py)"
moves = "frame_ms.p95"


def read(trace, ctx):
    busy = trace.busy()
    host = [s["dur"] - clipped(busy, s["ts"], s["ts"] + s["dur"])
            for s in trace.spans]
    return sum(host) / len(host) / 1e3
