"""Host ms a call from the start of the engine's ``process`` to the end
of its graph launch: the ``engine.process`` span's start to the end of
the last ``engine.replay`` span inside the call (the frame checks, the
staging wait and copy, the input copy's enqueue, the launch), the mean
over the calls that hold both spans."""

from benchlib.calls import PROCESS, REPLAY, calls, mean

name = "engine.launch_ms"
unit = "ms"
layer = "serving I/O (runtime/engine.py ServingIO, parallel/serving.py)"
moves = "frame_ms.p95"


def read(trace, ctx):
    per_call = []
    for c in calls(trace):
        start, end = c.first_start(PROCESS), c.last_end(REPLAY)
        if start is not None and end is not None and c.kernels:
            per_call.append((end - start) / 1e3)
    return mean(per_call)
