"""Device ms a frame of the warp's row gather (``index_elementwise``
kernels)."""

name = "warp.gather_ms"
unit = "ms"
layer = "warps (ops/warp.py)"
moves = "fps"
GROUP = "warp row gather (index)"


def read(trace, ctx):
    parts = trace.parts_ms()
    if GROUP not in parts:
        return None
    return parts[GROUP] / trace.frames
