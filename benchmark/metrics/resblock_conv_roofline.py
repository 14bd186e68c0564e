"""The res-block convs' share of their roofline, in %: the sum of the
bounds of the res-block conv work the configuration makes (res blocks x
2 convs at (N, H, W, C), ``flops.resblock_convs``, each bound the larger
of its bytes and its operations, ``flops.resblock_bound_s``) over the
device time of the kernels that implement it, found by the names below.
The work is counted from the configuration, not from the launches, so a
kernel that fuses the two convs is read on the same work."""

from benchlib.flops import resblock_bound_s

name = "resblock_conv_roofline"
unit = "%"
layer = "kernels (K1 csrc/resblock_conv.cu, K2 csrc/display_u8.cu)"
moves = "fps"
KERNEL_NAMES = ("conv3x3",)


def read(trace, ctx):
    peaks = ctx["peaks"]
    convs = ctx["resblock_convs"]
    if not peaks or not convs:
        return None
    parts = trace.parts_ms(group=lambda n: "k1" if any(
        k in n for k in KERNEL_NAMES) else "other")
    if parts.get("k1", 0.0) <= 0:
        return None
    bound_ms = sum(resblock_bound_s(*c, peaks) for c in convs) * 1e3
    return 100.0 * bound_ms * trace.calls / parts["k1"]
