"""Export a trained package to ONNX and verify the artifact end to end.

Port of ``tools/onnx_verify.py``: loads a serving package, writes the
reference-shaped deployment graph from its params
(``export.onnx_export.export_onnx``: no donor graph, no ``onnx``
package), runs the ``.onnx`` through ``OnnxClipRunner`` (the reference
runner's loop) over a recurrent clip of the rendered val frames, and
prints each frame's u8 difference from ``Engine`` serving the same
package.  Exits 1 if a frame differs by more than one u8 step.

    python -m joshupscale_torch.tools.onnx_verify export/frvsr/package \\
        [--frames 10] [--data data] [--out model.onnx] [--cpu]

Runs on the card unless ``--cpu`` (both the engine and the graph
runner).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package")
    ap.add_argument("--data", default="data")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="where to write the .onnx (default: inside the "
                         "package dir)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    import cv2

    from joshupscale_torch.export.onnx_export import export_onnx
    from joshupscale_torch.export.onnx_interp import (
        OnnxClipRunner,
        run_graph,
    )
    from joshupscale_torch.export.package import load_package
    from joshupscale_torch.runtime.engine import Engine

    lr_files = sorted(glob.glob(os.path.join(args.data, "val/lr/*.png")))
    if len(lr_files) < args.frames:
        raise ValueError(f"need a rendered val set of {args.frames} frames "
                         f"under {args.data}/val/lr")
    frames = np.stack([cv2.imread(p, cv2.IMREAD_COLOR)
                       for p in lr_files[:args.frames]])
    t, h, w, _ = frames.shape
    print(f"{t} frames, {w}x{h} -> {w * 4}x{h * 4}")

    model, params = load_package(args.package)
    m = dataclasses.replace(model, frame_height=h, frame_width=w)
    eng = Engine(m, params, device="cpu" if args.cpu else None)
    onnx_path = args.out or os.path.join(args.package, "model.onnx")
    export_onnx(onnx_path, params, h, w,
                num_flow_frames=m.num_flow_frames,
                frame_moving_avg=m.frame_moving_avg,
                output_flow=m.output_flow, remove_flow=m.remove_flow,
                flow_pad_factor=m.flow_pad_factor,
                normalize_brightness=m.normalize_brightness)
    print(f"exported {onnx_path} "
          f"({os.path.getsize(onnx_path) / 1e6:.1f} MB)")

    runner = OnnxClipRunner(onnx_path, h, w,
                            num_flow_frames=m.num_flow_frames,
                            stateless=m.remove_flow,
                            executor=run_graph if args.cpu else None)
    worst = 0
    for i in range(t):
        ours = eng.process(frames[i])
        theirs = runner.process(frames[i])
        d = int(np.abs(ours.astype(int) - theirs.astype(int)).max())
        frac = float(np.mean(ours != theirs))
        worst = max(worst, d)
        print(f"frame {i}: max u8 diff {d}  (pixels differing: "
              f"{frac:.2%})")
    print(f"worst frame diff: {worst} u8 step(s)")
    return 0 if worst <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
