"""Render a structured synthetic video dataset for training and
evaluation.

Port of ``tools/make_synth_dataset.py``.  Ten-frame sequences pan and
zoom a subpixel window smoothly over a source image (constant velocity
in [-3, 3] HR px a frame, a mild zoom drift, bilinear resampling,
reflected borders), in the layout the data pipeline's
``LocalDatasetOp`` reads:

- HR frames ``<split>/hr/seq_SSSS_f_F.png``, ``--hr-size`` square;
- LR frames ``<split>/lr/...``, nearest x4 downscales of the HR frames
  (as ``ParseSingleExampleOp`` makes LR: the model learns real
  aliasing).

``--format tfrecords`` writes pair-example TFRecords instead
(``<split>.tfrecords``: an Example of 10 ``input`` + 10 ``target`` PNGs,
written with ``data/tfrecord.py``).  Those PNGs decode to RGB, so a
config reading them adds ``RgbToBgrOp``.

    python -m joshupscale_torch.tools.make_synth_dataset data/ \\
        [--source IMG] [--train 200] [--val 20] [--hr-size 192] \\
        [--seed 0] [--format png|tfrecords]

``--source`` defaults to ``docs/learned_compare.png``.

Host only: numpy and cv2, no device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The repository's own 576x576 colour frame; the reference tool's default
# is a file of the upstream project, which no checkout of this one holds.
DEF_SOURCE = os.path.join(REPO, "docs", "learned_compare.png")


def render_sequence(src: np.ndarray, rng: np.random.Generator,
                    hr_size, frames: int = 10):
    """``frames`` HR crops along a smooth pan / zoom path over ``src``.

    ``hr_size``: an int (square) or (height, width); windows larger than
    the source sample reflected borders.
    """
    import cv2

    hr_h, hr_w = ((hr_size, hr_size) if isinstance(hr_size, int)
                  else hr_size)
    h, w = src.shape[:2]
    margin_x = min(hr_w + 64, w // 2 - 8)
    margin_y = min(hr_h + 64, h // 2 - 8)
    cx = rng.uniform(margin_x, w - margin_x)
    cy = rng.uniform(margin_y, h - margin_y)
    vx = rng.uniform(-3.0, 3.0)
    vy = rng.uniform(-3.0, 3.0)
    zoom0 = rng.uniform(0.8, 1.2)
    dzoom = rng.uniform(-0.01, 0.01)
    out = []
    for t in range(frames):
        zoom = zoom0 + dzoom * t
        # An (hr_w, hr_h) window centred at (cx + vx t, cy + vy t),
        # scaled by zoom, sampled bilinearly.
        tx = cx + vx * t
        ty = cy + vy * t
        m = np.array([[zoom, 0, tx - zoom * hr_w / 2],
                      [0, zoom, ty - zoom * hr_h / 2]], np.float32)
        out.append(cv2.warpAffine(
            src, m, (hr_w, hr_h),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            borderMode=cv2.BORDER_REFLECT))
    return out


def write_split(src, out_dir, split, count, hr_size, seed):
    """``count`` sequences as PNGs under ``out_dir/split/{hr,lr}``."""
    import cv2

    rng = np.random.default_rng(seed)
    hr_dir = os.path.join(out_dir, split, "hr")
    lr_dir = os.path.join(out_dir, split, "lr")
    os.makedirs(hr_dir, exist_ok=True)
    os.makedirs(lr_dir, exist_ok=True)
    lr_size = hr_size // 4
    for s in range(count):
        for f, hr in enumerate(render_sequence(src, rng, hr_size)):
            lr = hr[::4, ::4]  # nearest x1/4
            if lr.shape[:2] != (lr_size, lr_size):
                raise ValueError(f"--hr-size {hr_size} is not a multiple "
                                 f"of 4")
            name = f"seq_{s:04d}_f_{f}.png"
            cv2.imwrite(os.path.join(hr_dir, name), hr)
            cv2.imwrite(os.path.join(lr_dir, name), lr)
    print(f"{split}: {count} sequences ({count * 10} frames) at "
          f"{lr_size}->{hr_size}")


def write_tfrecords(src, out_dir, split, count, hr_size, seed):
    """``count`` pair examples in ``out_dir/split.tfrecords``."""
    import cv2

    from joshupscale_torch.data.tfrecord import encode_example, write_records

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{split}.tfrecords")

    def png(img):
        ok, buf = cv2.imencode(".png", img)
        if not ok:
            raise RuntimeError("PNG encoding failed")
        return buf.tobytes()

    def examples():
        for _ in range(count):
            hrs = render_sequence(src, rng, hr_size)
            yield encode_example({
                "input": [png(h[::4, ::4]) for h in hrs],
                "target": [png(h) for h in hrs],
            })

    n = write_records(path, examples())
    print(f"{split}: {n} pair examples -> {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--source", default=DEF_SOURCE)
    ap.add_argument("--train", type=int, default=200)
    ap.add_argument("--val", type=int, default=20)
    ap.add_argument("--hr-size", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--format", choices=("png", "tfrecords"),
                    default="png",
                    help="png: LocalDatasetOp's file layout; tfrecords: "
                         "pair-example TFRecords")
    args = ap.parse_args(argv)

    import cv2

    src = cv2.imread(args.source, cv2.IMREAD_COLOR)
    if src is None:
        raise SystemExit(f"cannot read source image {args.source}")
    print(f"source {args.source}: {src.shape}")
    writer = write_split if args.format == "png" else write_tfrecords
    writer(src, args.out_dir, "train", args.train, args.hr_size, args.seed)
    writer(src, args.out_dir, "val", args.val, args.hr_size, args.seed + 1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
