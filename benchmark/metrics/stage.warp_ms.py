"""Kernel ms a frame of the warp: the busy time of the call's kernels
between the end of the ``stage_end_flow`` marker and the start of the
``stage_end_warp`` marker (the s2d row gather, the table copy and the
combine, and the brightness added back), the mean over the calls that
hold both markers."""

from benchlib.calls import stage_ms

name = "stage.warp_ms"
unit = "ms"
layer = "warps (ops/warp.py)"
moves = "fps"


def read(trace, ctx):
    return stage_ms(trace, "stage_end_flow", "stage_end_warp")
