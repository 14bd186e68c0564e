"""Kernel time a display frame: the card's busy time in kernels (copies
left out) over the traced stretch, over its frames."""

name = "step.busy_ms"
unit = "ms"
layer = "model step (models/inference.py, replayed as the frame graph)"
moves = "fps"


def read(trace, ctx):
    return trace.busy_us(("kernel",)) / 1e3 / trace.frames
