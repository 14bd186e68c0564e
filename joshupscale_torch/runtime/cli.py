"""Offline upscale CLI: PNG/image sequence -> upscaled sequence.

Port of ``joshupscale_tpu/runtime/cli.py``: streams frames (read as BGR,
like training) through the recurrent engine in order and reports the
average per-frame latency.

Usage:
    python -m joshupscale_torch.runtime.cli <package> <in_dir> <out_dir>
        [--device N|cpu] [--limit K] [--compilation-cache]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def _device(value: str):
    return "cpu" if value == "cpu" else int(value)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Upscale an image sequence with a model package")
    parser.add_argument("package", help="model package directory")
    parser.add_argument("in_dir", help="directory of input frames "
                                       "(sorted by filename)")
    parser.add_argument("out_dir", help="output directory")
    parser.add_argument("--device", type=_device, default=0,
                        help="CUDA device index, or cpu")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--compilation-cache", action="store_true",
                        help="accepted for the reference CLI's sake; the "
                             "kernels' build cache (joshupscale_torch/"
                             "_build/) is always on, and there is no XLA "
                             "executable to cache")
    args = parser.parse_args(argv)

    import cv2

    from joshupscale_torch.runtime.engine import create_runtime

    files = sorted(
        f for f in glob.glob(os.path.join(args.in_dir, "*"))
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    if args.limit:
        files = files[:args.limit]
    if not files:
        print(f"no frames found in {args.in_dir}", file=sys.stderr)
        return 1

    engine = create_runtime(args.package, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    start = time.perf_counter()
    for path in files:
        frame = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR, like training
        if frame is None:
            print(f"cannot read {path}", file=sys.stderr)
            return 1
        out = engine.process(frame)
        cv2.imwrite(os.path.join(args.out_dir, os.path.basename(path)), out)
    total = time.perf_counter() - start

    n = len(files)
    print(f"processed {n} frames in {total:.2f}s "
          f"({total / n * 1e3:.2f} ms/frame incl. IO; "
          f"engine avg {engine.avg_frame_seconds * 1e3:.2f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
