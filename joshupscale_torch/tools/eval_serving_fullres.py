"""Serve learned weights at the production shape and measure quality.

Port of ``tools/eval_serving_fullres.py``.  ``eval_synth`` measures at
training crops; this tool serves the same weights (the nets are fully
convolutional) on a structured synthetic clip at the serving shape,
480x270 -> 1920x1080, through ``Engine`` (u8 frames, bf16, the s2d
path), and reports PSNR against the bilinear x4 baseline.  The clip is
``make_synth_dataset``'s pan / zoom over ``--source`` at the full HR
size, its LR the nearest x1/4 (the training data's convention).

    python -m joshupscale_torch.tools.eval_serving_fullres \\
        checkpoints/gan/latest.npz [--source IMG] [--frames 30] \\
        [--height 270 --width 480] [--seed 7] [--save-png P] [--cpu]
    python -m joshupscale_torch.tools.eval_serving_fullres export/pkg --package

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from joshupscale_torch.tools.make_synth_dataset import (
    DEF_SOURCE,
    render_sequence,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weights", help="train-state .npz checkpoint or model "
                    "package dir")
    ap.add_argument("--gan", action="store_true",
                    help="accepted as the reference tool accepts it: the "
                         "checkpoint layout is detected")
    ap.add_argument("--package", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--source", default=DEF_SOURCE)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save-png", metavar="PATH",
                    help="write a bilinear | model | ground-truth strip of "
                         "the last frame's centre 480x480 window")
    args = ap.parse_args(argv)

    import cv2

    from joshupscale_torch import resolve_device
    from joshupscale_torch.runtime.engine import Engine, create_runtime
    from joshupscale_torch.tools.val_data import (
        arch_config,
        bilinear_x4_u8,
        psnr,
    )
    from joshupscale_torch.training.trainer import exact_float32

    device = resolve_device("cpu" if args.cpu else None)
    src = cv2.imread(args.source, cv2.IMREAD_COLOR)
    if src is None:
        raise SystemExit(f"cannot read source image {args.source}")
    rng = np.random.default_rng(args.seed)
    hr = np.stack(render_sequence(src, rng, (args.height * 4,
                                             args.width * 4),
                                  frames=args.frames))
    lr = np.ascontiguousarray(hr[:, ::4, ::4])
    print(f"clip: {args.frames} frames {args.width}x{args.height} -> "
          f"{args.width * 4}x{args.height * 4}")

    with exact_float32():
        if args.package:
            eng = create_runtime(args.weights, device=device,
                                 frame_size=(args.height, args.width))
        else:
            from joshupscale_torch.export.importer import (
                load_trained_params,
            )
            from joshupscale_torch.models.registry import create_models

            built = create_models(arch_config(
                "quality", args.height, args.width, "bfloat16"),
                seed=0)["inference"]
            eng = Engine(built.obj, load_trained_params(args.weights,
                                                        built.params),
                         device=device)
        outs = eng.process_clip(lr[:, None])[:, 0]  # (T, 4H, 4W, 3) u8
    up_u8 = bilinear_x4_u8(lr, device)

    sl = slice(2, None)  # the zero-state warm-up frames
    p_model = psnr(outs[sl], hr[sl])
    p_bilinear = psnr(up_u8[sl], hr[sl])
    print(f"model    PSNR: {p_model:.2f} dB")
    print(f"bilinear PSNR: {p_bilinear:.2f} dB")
    print(f"margin: {p_model - p_bilinear:+.2f} dB")

    if args.save_png:
        y0, x0 = args.height * 2 - 240, args.width * 2 - 240
        win = (slice(y0, y0 + 480), slice(x0, x0 + 480))
        strip = np.concatenate([up_u8[-1][win], outs[-1][win],
                                hr[-1][win]], axis=1)
        cv2.imwrite(args.save_png, strip)
        print(f"wrote {args.save_png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
