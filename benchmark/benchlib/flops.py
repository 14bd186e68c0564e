"""The yardstick's arithmetic: model FLOPs a frame, the res-block convs'
work and their bounds, and the table of peaks.

FLOPs count every conv and transposed conv of the configuration's nets
from their shapes (2 x output pixels x taps x in x out channels), whatever
kernel runs them; the bilinear skip, the warp, batch norm and the
activations are not counted.  A res-block conv's bound is the larger of
its bytes (each input read once, the output written once: the input, the
residual where there is one, the output, the 3x3 weights in bf16 and the
f32 scale and offset) at the card's bandwidth and its operations at the
card's bf16 rate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# Published dense peaks (NVIDIA H100 SXM data sheet), by a substring of
# the name that torch.cuda.get_device_name() gives.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}
DTYPE_PEAK = {"bfloat16": "bf16_flops", "float16": "bf16_flops"}


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def conv_flops(h: int, w: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * h * w * k * k * cin * cout


def _nets(models: dict):
    inf = models["inference"]
    return (models[inf["flow"]["model"]], models[inf["generator"]["model"]],
            inf)


def padded_size(inf: dict) -> Tuple[int, int]:
    f = inf.get("flow_pad_factor")
    h, w = inf["frame_height"], inf["frame_width"]
    if not f:
        return h, w
    return -(-h // f) * f, -(-w // f) * f


def model_flops_per_frame(models: dict) -> float:
    """The FLOPs of one frame of the configuration's step."""
    flow, gen, inf = _nets(models)
    h, w = inf["frame_height"], inf["frame_width"]
    ph, pw = padded_size(inf)
    cin = flow.get("num_inputs", 4) * 3
    total = 0.0
    if flow["name"] == "flow-resnet":
        f = flow["num_filters"]
        total += conv_flops(ph, pw, 3, cin, f)
        total += 2 * flow["num_res_blocks"] * conv_flops(ph, pw, 3, f, f)
        total += conv_flops(ph, pw, 1, f, 32)
    elif flow["name"] == "flow-autoencoder":
        filters = flow["filters"]
        levels = len(filters) // 2
        sh, sw = ph, pw
        for i in range(2 * levels):
            total += conv_flops(sh, sw, 3, cin, filters[i])
            total += conv_flops(sh, sw, 3, filters[i], filters[i])
            cin = filters[i]
            sh, sw = (sh // 2, sw // 2) if i < levels else (sh * 2, sw * 2)
        if len(filters) % 2:
            total += conv_flops(sh, sw, 3, cin, filters[-1])
            cin = filters[-1]
        total += conv_flops(sh, sw, 3, cin, 32)
    else:
        raise ValueError(f"no FLOP count for flow net {flow['name']!r}")
    f = gen["num_filters"]
    total += conv_flops(h, w, 3, 3 + 48, f)
    total += 2 * gen["num_res_blocks"] * conv_flops(h, w, 3, f, f)
    total += conv_flops(h, w, 1, f, 4 * 32)  # deconv1: 2x2 stride 2
    total += conv_flops(2 * h, 2 * w, 1, 32, 4 * 3)  # deconv2
    return total


def resblock_convs(models: dict, n: int) -> List[tuple]:
    """(n, h, w, c, residual) of every res-block conv of one step at
    batch ``n``: each res block of each resnet, conv_1 without and conv_2
    with the residual."""
    flow, gen, inf = _nets(models)
    out = []
    for net, (h, w) in ((flow, padded_size(inf)),
                        (gen, (inf["frame_height"], inf["frame_width"]))):
        if not net["name"].endswith("resnet"):
            continue
        c = net["num_filters"]
        out += [(n, h, w, c, False), (n, h, w, c, True)] * \
            net["num_res_blocks"]
    return out


def resblock_bound_s(n: int, h: int, w: int, c: int, residual: bool,
                     peaks: Dict[str, float]) -> float:
    act = n * h * w * c * 2
    nbytes = act * (3 if residual else 2) + 9 * c * c * 2 + 2 * c * 4
    ops = 2.0 * n * h * w * 9 * c * c
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["bf16_flops"])
