"""Kernel ms a frame of the flow stage: the busy time of the call's
kernels before the start of the ``stage_end_flow`` marker (the
preprocess, brightness, padding and the flow net), the mean over the
calls that hold the marker."""

from benchlib.calls import stage_ms

name = "stage.flow_ms"
unit = "ms"
layer = "flow net (models/fnet.py, with preprocess, brightness and pad)"
moves = "fps"


def read(trace, ctx):
    return stage_ms(trace, None, "stage_end_flow")
