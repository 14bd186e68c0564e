"""Plain float32 reference of the recurrent x4 upscaler's serving step.

Written from the model's equations, in plain PyTorch, for the benchmark's
check of the frames that the program served.  It imports nothing of the
program: it reads the configuration's ``models`` entry and the raw
weights that the benchmark made (a nested dict of tensors in the
program's raw layouts: conv kernels OHWI, a transposed conv's kernel as
its (I, 4*O) product with output channel ``(dy*2 + dx)*O + o``), and
works out every fold, padding and state itself.

One step, on the pixel grid (the served form keeps the recurrence in
space-to-depth form; the values are the same):

    pre       = u8 / 255 - 0.5
    bright    = mean(pre * BGR luma * 3)         (normalize_brightness)
    cur       = zero-pad(pre - bright)           (flow_pad_factor)
    flow      = FNet(cur, last_1, ..., last_k)   (N, 4H, 4W, 2), crop
    pre_warp  = warp(pre_gen, flow) + bright
    out       = Generator(pre, s2d(pre_warp))
    display   = u8(trunc((out + 0.5) * 255))
    pre_gen'  = out - bright;  last' = [cur] + last[:-1]

The flow net is a resnet (conv-BN-ReLU, res blocks, 1x1 head) or an
autoencoder (double conv-BN-ReLU with 2x2 max pools down and x2 TF1
bilinear upscales up, an optional mid conv, a 3x3 head); both heads give
32 channels made into the HR flow by depth_to_space(4).  The warp is
tfa's ``dense_image_warp``: a bilinear sample at ``(y - fy, x - fx)``,
the floor corner clamped to ``[0, size - 2]`` and the weight to
``[0, 1]``.  Batch norm is inference batch norm, epsilon 1e-3.  Every
float op runs in ``dtype`` (float32 by default, TF32 off).  ``rounding``
(a dtype such as ``torch.float8_e4m3fn``) rounds the weights and every
op's output through that type: the reference in a lower precision, the
benchmark's control.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BGR_LUMA = (0.1140, 0.5870, 0.2989)


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def depth_to_space(x: torch.Tensor, b: int) -> torch.Tensor:
    """(N, H, W, b*b*C) -> (N, bH, bW, C), channel ``(ry*b + rx)*C + c``."""
    n, h, w, c = x.shape
    c //= b * b
    return x.reshape(n, h, w, b, b, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h * b, w * b, c)


def space_to_depth(x: torch.Tensor, b: int) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // b, b, w // b, b, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, b * b * c)


def upscale_bilinear(x: torch.Tensor, s: int) -> torch.Tensor:
    """TF1 bilinear resize by an integer ``s`` (align_corners and
    half-pixel centres off): output row ``y`` samples input row ``y / s``,
    the row below clamped at the edge; the same for columns."""
    n, h, w, c = x.shape

    def axis(size):
        src = torch.arange(size * s, device=x.device, dtype=torch.float64) / s
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=size - 1)
        return lo, hi, (src - lo).to(x.dtype)

    ylo, yhi, fy = axis(h)
    xlo, xhi, fx = axis(w)
    top, bot = x[:, ylo], x[:, yhi]
    rows = top + (bot - top) * fy.view(1, -1, 1, 1)
    left, right = rows[:, :, xlo], rows[:, :, xhi]
    return left + (right - left) * fx.view(1, 1, -1, 1)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def dense_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``out[n, y, x] = bilinear(image, (y - flow_y, x - flow_x))`` with
    tfa's edge clamping; ``flow`` (N, H, W, 2), channel 0 the y offset."""
    n, h, w, c = image.shape
    dev, dt = image.device, image.dtype
    qy = torch.arange(h, device=dev, dtype=dt).view(1, h, 1) - flow[..., 0]
    qx = torch.arange(w, device=dev, dtype=dt).view(1, 1, w) - flow[..., 1]
    y0 = torch.clamp(torch.floor(qy), 0, h - 2)
    x0 = torch.clamp(torch.floor(qx), 0, w - 2)
    ay = torch.clamp(qy - y0, 0, 1)[..., None]
    ax = torch.clamp(qx - x0, 0, 1)[..., None]
    y0, x0 = y0.long(), x0.long()
    flat = image.reshape(n, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, idx).reshape(n, h, w, c)

    tl, tr = at(y0, x0), at(y0, x0 + 1)
    bl, br = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    top = tl + (tr - tl) * ax
    bot = bl + (br - bl) * ax
    return top + (bot - top) * ay


class Nets:
    """The layers and nets; ``q`` rounds each layer's output (the
    identity, or a trip through a lower-precision type)."""

    def __init__(self, q=lambda x: x):
        self.q = q

    def conv(self, x, p):
        """NHWC SAME conv, stride 1, odd square OHWI kernel, optional
        bias."""
        k = p["kernel"]
        out = F.conv2d(x.permute(0, 3, 1, 2), k.permute(0, 3, 1, 2),
                       padding=k.shape[1] // 2).permute(0, 2, 3, 1)
        if "bias" in p:
            out = out + p["bias"]
        return self.q(out)

    def batch_norm(self, x, p):
        inv = p["gamma"] / torch.sqrt(p["moving_variance"] + BN_EPS)
        return self.q((x - p["moving_mean"]) * inv + p["beta"])

    def conv_bn_relu(self, x, conv_p, bn_p):
        return torch.relu(self.batch_norm(self.conv(x, conv_p), bn_p))

    def res_block(self, x, p):
        y = self.conv_bn_relu(x, p["conv_1"], p["bn_1"])
        y = self.batch_norm(self.conv(y, p["conv_2"]), p["bn_2"])
        return self.q(torch.relu(y + x))

    def flow_resnet(self, p, x):
        out = self.conv_bn_relu(x, p["conv_1"], p["bn_1"])
        for i in range(sum(k.startswith("block_") for k in p)):
            out = self.res_block(out, p[f"block_{i + 1}"])
        return self.conv(out, p["conv_2"])

    def flow_autoencoder(self, p, x):
        levels = sum(k.startswith("block_") for k in p) // 2
        out = x
        for i in range(2 * levels):
            b = p[f"block_{i + 1}"]
            out = self.conv_bn_relu(out, b["conv_1"], b["bn_1"])
            out = self.conv_bn_relu(out, b["conv_2"], b["bn_2"])
            out = max_pool_2x(out) if i < levels else self.q(
                upscale_bilinear(out, 2))
        if "conv_1" in p:
            out = self.conv_bn_relu(out, p["conv_1"], p["bn_1"])
        return self.conv(out, p["conv_2"])

    def deconv_2x(self, x, p):
        """Kernel-2 stride-2 transposed conv from its (I, 4*O) product:
        the taps do not overlap, so each input pixel writes its own 2x2
        block."""
        out = depth_to_space(x @ p["kernel"], 2)
        if "bias" in p:
            out = out + p["bias"]
        return self.q(out)

    def generator(self, p, pre, pre_warp):
        out = torch.cat([pre, space_to_depth(pre_warp, 4)], dim=-1)
        out = self.conv_bn_relu(out, p["conv_1"], p["bn_1"])
        for i in range(sum(k.startswith("block_") for k in p)):
            out = self.res_block(out, p[f"block_{i + 1}"])
        out = torch.relu(self.batch_norm(
            self.deconv_2x(out, p["conv_trans_1"]), p["bn_2"]))
        out = self.q(torch.tanh(self.deconv_2x(out, p["conv_trans_2"])))
        skip = self.q(upscale_bilinear(pre, 4))
        return self.q(torch.clamp(skip + out, -0.5, 0.5))


FLOW_NETS = {"flow-resnet": "flow_resnet",
             "flow-autoencoder": "flow_autoencoder"}


class Reference:
    """The step of a configuration's ``inference`` entry (``models``:
    the configuration's model dict, as the program's registry reads it)
    on raw ``params`` ({"flow": ..., "generator": ...}), in float32, or
    rounded through ``rounding`` after every layer (the control)."""

    def __init__(self, models: dict, params, device, rounding=None):
        inf = models["inference"]
        flow_cfg = models[inf["flow"]["model"]]
        self.num_last = flow_cfg.get("num_inputs", 4) - 1
        self.h, self.w = inf["frame_height"], inf["frame_width"]
        f = inf.get("flow_pad_factor")
        self.ph = self.h if not f else -(-self.h // f) * f
        self.pw = self.w if not f else -(-self.w // f) * f
        self.bright = bool(inf.get("normalize_brightness", False))
        self.device = device
        if rounding is None:
            q = lambda x: x  # noqa: E731
        else:
            q = lambda x: x.to(rounding).float()  # noqa: E731
        self.q = q
        self.nets = Nets(q)
        self.flow_net = getattr(self.nets, FLOW_NETS[flow_cfg["name"]])

        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            return q(tree.to(device, torch.float32))

        self.params = cast(params)

    def init_state(self, n: int) -> dict:
        z = lambda *s: torch.zeros(s, device=self.device)  # noqa: E731
        return {"pre_gen": z(n, 4 * self.h, 4 * self.w, 3),
                "last_frames": [z(n, self.ph, self.pw, 3)
                                for _ in range(self.num_last)]}

    def step(self, frame_u8: torch.Tensor, state: dict):
        """(N, H, W, 3) u8 -> (display (N, 4H, 4W, 3) u8, new state,
        flow (N, 4H, 4W, 2) in HR pixels)."""
        q = self.q
        pre = q(frame_u8.to(self.device, torch.float32) / 255.0 - 0.5)
        bright = 0.0
        cur = pre
        if self.bright:
            luma = torch.tensor(BGR_LUMA, device=self.device) * 3.0
            bright = q((pre * luma).mean(dim=(1, 2, 3), keepdim=True))
            cur = q(pre - bright)
        dh, dw = self.ph - self.h, self.pw - self.w
        top, left = dh // 2, dw // 2
        cur = F.pad(cur, (0, 0, left, dw - left, top, dh - top))
        frames: List[torch.Tensor] = [cur] + state["last_frames"]
        flow = depth_to_space(
            self.flow_net(self.params["flow"], torch.cat(frames, dim=-1)), 4)
        flow = flow[:, 4 * top:4 * (top + self.h),
                    4 * left:4 * (left + self.w)]
        pre_warp = q(q(dense_warp(state["pre_gen"], flow)) + bright)
        out = self.nets.generator(self.params["generator"], pre, pre_warp)
        display = ((out + 0.5) * 255.0).to(torch.uint8)
        new_state = {"pre_gen": q(out - bright),
                     "last_frames": [cur] + state["last_frames"][:-1]}
        return display, new_state, flow
