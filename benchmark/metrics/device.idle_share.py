"""Share of the traced stretch in which no kernel and no copy runs on
the card, in %."""

name = "device.idle_share"
unit = "%"
layer = "device"
moves = "fps"


def read(trace, ctx):
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
