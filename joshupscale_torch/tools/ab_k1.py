"""K1's launch times and the fast tier's ``step.pt2`` of one checkout of
the repo, for comparing two commits on one card in one call:

    python3 joshupscale_torch/tools/ab_k1.py <checkout_dir> [<package_dir>]

run once per checkout, in turns (parent, change, change, parent), as a
script: with ``-m`` the package would come from the current directory
instead of the checkout, which ``main`` refuses.  It imports that
checkout's ``chip_smoke.py`` and package and builds its kernels, then:

* times K1's conv_1 (no residual) and conv_2 (residual) at
  (1, 270, 480, C) bf16 for C = 32, 48 and 64 with
  ``chip_smoke.time_k1`` (CUDA events over 20 launches back to back,
  the bound from ``chip_smoke.k1_bound_ms``, ``F.conv2d`` beside);
* times K1 at C = 32 from one tile to 4 frames (``time_scaling``: a
  launch's fixed cost and a tile's);
* times the fast tier's flow-net chain alone: 6 res blocks of two K1
  launches at (1, 270, 480, 32), chained (CUDA events);
* given ``package_dir``, a package with its ``step.pt2`` written for
  the card by ``make_model_set`` (the same directory for every
  checkout), loads that step with the checkout's op library and times a
  frame on the card (``tools.timing.cuda_time_ms``: 20 frames back to
  back, 5 runs, median), then traces 5 frames: a frame's device busy
  time by part, K1 split by its channel count (an interval that
  overlaps one that started earlier counts past that one's end only,
  ``busy_parts`` of this file's ``tools/timing.py``), and K1's launches
  and summed record time a frame.

Prints one JSON object on a line starting with ``AB``.  Needs a CUDA
card.
"""

from __future__ import annotations

import json
import os
import re
import sys

STEP_FRAMES = 20  # frames timed back to back in each of 5 runs
TRACED_FRAMES = 5  # frames in the traced window, their parts averaged


def step_part(name: str, group) -> str:
    """A kernel record's part of the step: K1 split by its channel count
    (its instantiation, ``conv3x3_bf16_kernel<32>``, mangled or not),
    else ``group(name)``."""
    m = re.search(r"conv3x3_(bf16|f32)_kernel(?:<|ILi)(\d+)", name)
    return f"K1 {m.group(1)} C={m.group(2)}" if m else group(name)


def own_timing():
    """This file's own ``tools/timing.py`` (``busy_parts``, which an older
    checkout's lacks), loaded apart from the checkout's package."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "timing.py")
    spec = importlib.util.spec_from_file_location("ab_k1_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SCALING_SHAPES = ((1, 8, 16), (1, 64, 128), (1, 270, 480), (2, 270, 480),
                  (4, 270, 480))


def time_scaling(torch, device, c=32):
    """K1 conv_1 / conv_2 at C = ``c`` bf16 over ``SCALING_SHAPES``: one
    tile; 64 tiles (at most one a CTA); 1020, 2040 and 4080 tiles (about
    8, 16 and 31 a CTA), so that the times split into a launch's fixed
    cost and a tile's.  µs a launch, 20 launches back to back (CUDA
    events, ``tools.timing.cuda_time_ms``)."""
    import numpy as np

    from joshupscale_torch.kernels.resblock import resblock_conv3x3
    from joshupscale_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(7)
    s = torch.ones(c, device=device)
    o = torch.zeros(c, device=device)
    wt = torch.from_numpy(rng.standard_normal((c, 3, 3, c)).astype(
        np.float32) / np.sqrt(9 * c)).to(device, torch.bfloat16)
    out = {}
    for shape in SCALING_SHAPES:
        x, r = (torch.from_numpy(rng.standard_normal((*shape, c)).astype(
            np.float32)).to(device, torch.bfloat16) for _ in range(2))
        out["x".join(map(str, shape))] = [
            cuda_time_ms(lambda: resblock_conv3x3(x, wt, s, o, res, "relu"),
                         reps=20) * 1e3
            for res in (None, r)]
    return out


def time_chain(torch, device, blocks=6, c=32):
    """The fast tier's flow-net res blocks alone: ``blocks`` blocks of two
    K1 launches each (conv_1, then conv_2 with the block's input as
    residual) at (1, 270, 480, c) bf16, chained, ms a chain (CUDA events,
    ``tools.timing.cuda_time_ms``)."""
    import numpy as np

    from joshupscale_torch.kernels.resblock import resblock_conv3x3
    from joshupscale_torch.tools.timing import cuda_time_ms

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 270, 480, c)).astype(
        np.float32) * 0.5).to(device, torch.bfloat16)
    ws = [torch.from_numpy(rng.standard_normal((c, 3, 3, c)).astype(
        np.float32) / np.sqrt(9 * c) / 2).to(device, torch.bfloat16)
        for _ in range(2 * blocks)]
    s = torch.ones(c, device=device)
    o = torch.zeros(c, device=device)

    def chain():
        y = x
        for b in range(blocks):
            h = resblock_conv3x3(y, ws[2 * b], s, o, None, "relu")
            y = resblock_conv3x3(h, ws[2 * b + 1], s, o, y, "relu")

    return cuda_time_ms(chain, reps=10)


def time_step(torch, cs, package, device):
    """The package's ``step.pt2`` on the card: ms a frame (CUDA events)
    and one traced frame's K1 launches, busy ms and K1 part."""
    from joshupscale_torch.export.package import (
        load_aoti_step,
        load_package,
        state_leaves,
    )
    from joshupscale_torch.tools.timing import cuda_time_ms

    model, _ = load_package(package)
    step = load_aoti_step(package)
    frames = cs.frames_for(2, 0)
    frame = torch.from_numpy(frames[0][None]).to(device)
    state = [state_leaves(model.init_state(1, device=device))]

    def run():
        state[0] = step(frame, *state[0])[1:]

    def frames():
        for _ in range(TRACED_FRAMES):
            run()

    with torch.no_grad():
        for _ in range(3):
            run()
        ms = cuda_time_ms(run, reps=STEP_FRAMES)
        _, events = cs.profiled(torch, frames)
    parts = own_timing().busy_parts(
        events, lambda name: step_part(name, cs.kernel_group))
    k1 = {}
    for e in events:
        part = step_part(e["name"], cs.kernel_group)
        if part.startswith("K1"):
            n, dur = k1.get(part, (0, 0.0))
            k1[part] = (n + 1, dur + e["dur"] / 1e3)
    return {"frame_ms": ms,
            "busy_ms": sum(parts.values()) / TRACED_FRAMES,
            "parts_ms": {p: v / TRACED_FRAMES for p, v in parts.items()},
            "k1_launches": {p: n / TRACED_FRAMES for p, (n, _) in k1.items()},
            "k1_record_ms": {p: d / TRACED_FRAMES
                             for p, (_, d) in k1.items()}}


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    package = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    import joshupscale_torch
    from joshupscale_torch.kernels import _build

    if not os.path.abspath(joshupscale_torch.__file__).startswith(root):
        raise RuntimeError(f"joshupscale_torch comes from "
                           f"{joshupscale_torch.__file__}, not {root}: "
                           f"run this file as a script")
    _build.build_all()
    _build.ops()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"checkout": os.path.basename(root), "k1": {}}
    for c in (32, 48, 64):
        k1, lib_ms = cs.time_k1(torch, dev, c)
        out["k1"][c] = {name: {"ms": ms, "bound_ms": bound,
                               "share_of_bound": bound / ms}
                        for name, (ms, _, bound, _) in k1.items()}
        out["k1"][c]["library_ms"] = lib_ms
    out["scaling_us"] = time_scaling(torch, dev)
    out["chain_ms"] = time_chain(torch, dev)
    if package:
        out["step"] = time_step(torch, cs, package, dev)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
