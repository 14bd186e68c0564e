"""Device ms a frame of the unfused passes: the kernel groups "other
elementwise" and "cat" (the warp's copy and 25-term combine, the
generator tail, casts, the autoencoder's batch norm and activations)."""

name = "elementwise_ms"
unit = "ms"
layer = "unfused passes (warp copy and combine, generator tail, casts, batch norm)"
moves = "fps"
GROUPS = ("other elementwise", "cat (tables, inputs, stacks)")


def read(trace, ctx):
    parts = trace.parts_ms()
    if not any(g in parts for g in GROUPS):
        return None
    return sum(parts.get(g, 0.0) for g in GROUPS) / trace.frames
