"""Conv probe: the res-block conv's product and patch build, timed apart.

    python -m joshupscale_torch.tools.conv_probe [--tile 1296] [--variants patch,pair]

Times, at the res-block conv's shape (270 x 480 positions, 64 -> 64
channels, bf16), the parts of K1's work on their own:

  cudnn            cuDNN's conv + relu (F.conv2d, channels-last): the
                   yardstick, not a kernel of the port
  dot64_resident   P1: (1296, 576) @ (576, 64) per tile, A_blk held in
                   shared memory: the product alone
  dot128_resident  P1 at N = 128
  dot64_stream     P1 with A streamed from device memory (149 MB)
  patch            P2: 9-tap patch build + product + relu
  pair             P2: the whole res block (two products, residual add)

The inputs are those of ``tools/pallas_conv_probe.py``: seeded numpy
``default_rng(0)``, standard normal, P2's weights scaled by 0.05.  Each
kernel is first held against its plain version on the card, then timed
with CUDA events over back-to-back launches (median of 5 runs); each
time is printed with its share of the H100's dense bf16 peak,
989 TFLOP/s.  Needs a CUDA device: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from joshupscale_torch.kernels.probes import (
    C,
    HALO,
    K,
    M,
    PW,
    pair_tail_bound,
    probe_dot,
    probe_dot_bound,
    probe_dot_plain,
    probe_patch_dot,
    probe_patch_dot_bound,
    probe_patch_dot_plain,
    within_bound,
)
from joshupscale_torch.tools.timing import card_line, cuda_time_ms

# H100 SXM data sheet, dense: the bound of each probe.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
H, W = 270, 480
DOT_VARIANTS = {"dot64_resident": (64, True), "dot128_resident": (128, True),
                "dot64_stream": (64, False)}
VARIANTS = ("cudnn",) + tuple(DOT_VARIANTS) + ("patch", "pair")
DOT_TILE = 1296    # P1's tile_m, as in the JAX tool
PATCH_TILE = 2416
MIN_SHARED_ROWS = 0.9  # of the pair's rows, compared on a shared y1
BF16 = torch.bfloat16


@dataclass
class Probe:
    """One variant on the card: ``run`` launches it once; ``plain`` and
    ``library`` compute the same function another way (None where there
    is none); ``expect()`` gives what ``run`` is held against, the
    element-wise bound of the difference and the output rows to compare
    (None: all)."""

    name: str
    flops: float
    nbytes: float
    run: Callable[[], torch.Tensor]
    plain: Optional[Callable[[], torch.Tensor]] = None
    expect: Optional[Callable[[], Tuple[torch.Tensor, torch.Tensor,
                                        Optional[torch.Tensor]]]] = None
    library: Optional[Callable[[], torch.Tensor]] = None
    library_call: Optional[str] = None

    def bound_ms(self):
        """(least time in ms, "bytes" or "operations")."""
        t_bytes = self.nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = self.flops / PEAK_BF16_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")

    def share_of_peak(self, ms: float) -> float:
        return self.flops / (ms * 1e-3) / PEAK_BF16_FLOPS


def _bf16(rng, shape, device, scale=1.0):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32) * scale).to(device, BF16)


def _conv_operands(device):
    """(x NCHW view of NHWC memory, w OIHW channels-last) bf16."""
    rng = np.random.default_rng(0)
    x = _bf16(rng, (1, H, W, C), device).permute(0, 3, 1, 2)
    w = _bf16(rng, (3, 3, C, C), device, 0.05).permute(3, 2, 0, 1)
    return x, w.contiguous(memory_format=torch.channels_last)


def _conv_relu(x, w):
    return torch.relu(F.conv2d(x, w, padding=1))


def make_probe(name: str, tile: int, device) -> Probe:
    """The variant ``name`` with its inputs on ``device``."""
    if name == "cudnn":
        x, w = _conv_operands(device)
        return Probe(name, 2.0 * H * W * 9 * C * C,
                     2 * (2 * H * W * C + 9 * C * C),
                     lambda: _conv_relu(x, w))
    if name in DOT_VARIANTS:
        n, resident = DOT_VARIANTS[name]
        rng = np.random.default_rng(0)
        a = _bf16(rng, (tile if resident else M, K), device)
        if resident:
            a = a.repeat(M // tile, 1)
        b = _bf16(rng, (K, n), device)
        a_read = tile if resident else M

        def expect():
            ref = probe_dot_plain(a, b, tile, resident)
            return ref, probe_dot_bound(a, b, tile, resident, ref), None
        return Probe(
            name, 2.0 * M * K * n, 2 * (a_read * K + K * n + M * n),
            lambda: probe_dot(a, b, tile, resident),
            plain=lambda: probe_dot_plain(a, b, tile, resident),
            expect=expect, library=lambda: torch.matmul(a, b),
            library_call="torch.matmul(A, B) bf16")
    if name in ("patch", "pair"):
        pair = name == "pair"
        rng = np.random.default_rng(0)
        buf_rows = -(-(PATCH_TILE + 2 * HALO) // 8) * 8
        x = _bf16(rng, (buf_rows, C), device)
        w = _bf16(rng, (K, C), device, 0.05)
        rows = (M // PATCH_TILE) * PATCH_TILE
        x_read = PATCH_TILE + HALO + (PW + 1 if pair else 0)
        cx, cw = _conv_operands(device)
        if pair:
            def library():
                return F.conv2d(_conv_relu(cx, cw), cw, padding=1) + cx
            call = ("cuDNN conv + relu, conv, add at (1, 270, 480, 64) "
                    "(conv-equivalent yardstick)")

            def expect():
                # The plain pair, on the rows whose first product y1 the
                # kernel rounds as the plain version does: a y1 one ulp
                # apart spreads through nine copies of w2.
                ref = probe_patch_dot_plain(x, w, w, PATCH_TILE, True)
                y1 = probe_patch_dot_plain(x, w, w, PATCH_TILE)[:PATCH_TILE]
                y1_kernel = probe_patch_dot(x, w, w, PATCH_TILE)[:PATCH_TILE]
                same = (y1_kernel == y1).all(dim=1).repeat(M // PATCH_TILE)
                return ref, pair_tail_bound(y1, x, w, ref), same
        else:
            def library():
                return _conv_relu(cx, cw)
            call = ("cuDNN conv + relu at (1, 270, 480, 64) "
                    "(conv-equivalent yardstick)")

            def expect():
                ref = probe_patch_dot_plain(x, w, w, PATCH_TILE)
                return (ref, probe_patch_dot_bound(x, w, PATCH_TILE, ref),
                        None)
        return Probe(
            name, 2.0 * rows * K * C * (2 if pair else 1),
            2 * (x_read * C + (2 if pair else 1) * K * C + rows * C),
            lambda: probe_patch_dot(x, w, w, PATCH_TILE, pair),
            plain=lambda: probe_patch_dot_plain(x, w, w, PATCH_TILE, pair),
            expect=expect, library=library, library_call=call)
    raise ValueError(f"unknown variant {name!r}; known: "
                     f"{', '.join(VARIANTS)}")


def check(probe: Probe) -> float:
    """Hold the kernel against its plain version on the card (the pair
    on the rows whose first product both round alike, which must be at
    least MIN_SHARED_ROWS of them); returns the largest difference,
    raises if any element is outside the bound."""
    got = probe.run()
    torch.cuda.synchronize()
    ref, bound, rows = probe.expect()
    if got.shape != ref.shape:
        raise AssertionError(f"{probe.name}: shape {tuple(got.shape)}, "
                             f"expected {tuple(ref.shape)}")
    if rows is not None:
        share = float(rows.float().mean())
        if share < MIN_SHARED_ROWS:
            raise AssertionError(f"{probe.name}: the first product differs "
                                 f"from the plain one on {1 - share:.1%} "
                                 f"of the rows")
        got, ref, bound = got[rows], ref[rows], bound[rows]
    ok, err = within_bound(got, ref, bound)
    if not ok:
        raise AssertionError(f"{probe.name}: kernel and plain version "
                             f"disagree (max |diff| {err:.4g})")
    return err


def run(variants, tile: int, device, log=print) -> dict:
    """Check and time each variant, its plain version and its library
    yardstick.  Logs one line each and returns {name: {"ms",
    "share_of_bf16_peak", "fraction_of_bound", "bound_ms", "bound_by",
    "library_ms", "library_call", "plain_ms", "max_abs_err"}} (None where
    there is nothing to measure)."""
    out = {}
    for name in variants:
        probe = make_probe(name, tile, device)
        err = check(probe) if probe.expect else None
        ms = cuda_time_ms(probe.run, reps=20)
        bound, by = probe.bound_ms()
        rec = {"ms": ms, "share_of_bf16_peak": probe.share_of_peak(ms),
               "fraction_of_bound": bound / ms, "bound_ms": bound,
               "bound_by": by, "library_call": probe.library_call,
               "library_ms": (cuda_time_ms(probe.library, reps=20)
                              if probe.library else None),
               "plain_ms": (cuda_time_ms(probe.plain, reps=5)
                            if probe.plain else None),
               "max_abs_err": err}
        out[name] = rec
        extra = "".join(
            f"; {label} {rec[key] * 1e3:.2f} us" for key, label in (
                ("library_ms", "library"), ("plain_ms", "plain"))
            if rec[key] is not None)
        if err is not None:
            extra += f"; vs plain max |diff| {err:.4g}"
        log(f"{name:16s}: {ms * 1e3:9.2f} us  "
            f"({rec['share_of_bf16_peak']:6.1%} of the 989 TFLOP/s bf16 "
            f"peak; bound {bound * 1e3:.2f} us, {by}, "
            f"{rec['fraction_of_bound']:.1%} of its rate{extra})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=DOT_TILE,
                    help="P1's tile_m (must divide 129600)")
    ap.add_argument("--variants", default="patch,pair",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {', '.join(VARIANTS)}")
    if args.tile < 1 or M % args.tile:
        ap.error(f"--tile must divide {M}")
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device; the probe times the card and has "
              "no CPU mode", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}; conv-equivalent at 100% "
          f"of the bf16 peak: {2.0 * M * K * C / PEAK_BF16_FLOPS * 1e6:.2f} "
          f"us", flush=True)
    run(variants, args.tile, torch.device("cuda"),
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
