"""The whole step's share of the card's peak: the configuration's model
FLOPs a frame (every conv and transposed conv, from its shapes) times
the frames of the traced stretch, over the stretch's length times the
peak of the compute dtype, in %."""

from benchlib.flops import DTYPE_PEAK

name = "step_mfu"
unit = "%"
layer = "model step (models/inference.py, replayed as the frame graph)"
moves = "fps"


def read(trace, ctx):
    peaks = ctx["peaks"]
    if not peaks or ctx["dtype"] not in DTYPE_PEAK:
        return None
    work = ctx["flops_per_frame"] * trace.frames
    return 100.0 * work / (trace.window_us / 1e6 * peaks[DTYPE_PEAK[
        ctx["dtype"]]])
