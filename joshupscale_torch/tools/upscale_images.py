"""Upscale a sorted image sequence through a model package.

Port of ``tools/upscale_images.py`` (the reference's user-facing runner:
sorted image globs -> recurrent engine -> a PNG per frame -> the average
seconds a frame).  The recurrent state carries across the images (video
as frames: the order matters).  ``--onnx`` runs an exported ``.onnx``
through ``OnnxClipRunner`` instead of ``Engine`` (the reference's
onnxruntime runner's counterpart; a verification path, not a fast one).
Images are read and written BGR (cv2), as the reference's pipeline is.

    python -m joshupscale_torch.tools.upscale_images -p <package_dir> \\
        -o <out_dir> [--cpu] [--onnx model.onnx] <glob|dir|file>...

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from glob import glob


def list_images(image_paths):
    """Recursive glob expansion (a directory lists its files)."""
    for path in image_paths:
        for filename in glob(path, recursive=True):
            if os.path.isdir(filename):
                yield from list_images([os.path.join(filename, "*")])
            else:
                yield filename


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Upscale an image sequence (recurrent)")
    ap.add_argument("-p", "--package", required=True,
                    help="model package directory (export.package)")
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("--onnx", default=None,
                    help="run this exported .onnx through OnnxClipRunner "
                         "instead of the engine")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("image_paths", nargs="+")
    args = ap.parse_args(argv)

    import cv2
    import numpy as np

    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(list_images(args.image_paths))
    if not files:
        print("no input images matched", file=sys.stderr)
        return 1

    if args.onnx:
        from joshupscale_torch.export.onnx_interp import (
            OnnxClipRunner,
            run_graph,
        )

        probe = cv2.imread(files[0], cv2.IMREAD_COLOR)
        if probe is None:
            raise ValueError(f"Could not open image: {files[0]}")
        process = OnnxClipRunner(args.onnx, probe.shape[0], probe.shape[1],
                                 executor=run_graph if args.cpu
                                 else None).process
    else:
        from joshupscale_torch.runtime.engine import create_runtime

        process = create_runtime(args.package, device="cpu" if args.cpu
                                 else None).process

    num, total = 0, 0.0
    for path in files:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"Could not open image: {path}")
        start = time.time()
        out = np.asarray(process(img))
        total += time.time() - start
        num += 1
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output_dir, f"{name}.png")
        if not cv2.imwrite(out_path, out):
            raise OSError(f"could not write {out_path}")
    print(f"processed {num} images, average time: {total / num:f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
