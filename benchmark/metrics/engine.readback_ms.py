"""Host ms a call from the end of the card's last kernel of the call to
the end of the engine's ``engine.readback`` span: the display frame's
copy to host memory, its pageable allocation and the return to the
caller after the frame is done, the mean over the calls that hold the
span."""

from benchlib.calls import READBACK, calls, mean

name = "engine.readback_ms"
unit = "ms"
layer = "serving I/O (runtime/engine.py ServingIO, parallel/serving.py)"
moves = "frame_ms.p95"


def read(trace, ctx):
    per_call = []
    for c in calls(trace):
        end, last = c.last_end(READBACK), c.kernel_end()
        if end is not None and last is not None:
            per_call.append((end - last) / 1e3)
    return mean(per_call)
