"""Kernel ms a frame of the generator: the busy time of the call's
kernels between the end of the ``stage_end_warp`` marker and the start
of the ``stage_end_generator`` marker (the generator and its tail, and
the moving average), the mean over the calls that hold both markers.
The state commit and the display kernel come after the marker."""

from benchlib.calls import stage_ms

name = "stage.generator_ms"
unit = "ms"
layer = "generator (models/generator.py)"
moves = "fps"


def read(trace, ctx):
    return stage_ms(trace, "stage_end_warp", "stage_end_generator")
