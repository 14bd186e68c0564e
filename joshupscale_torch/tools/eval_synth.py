"""Held-out PSNR of a model against the bilinear x4 baseline.

Port of ``tools/eval_synth.py``: the inference model streams the
held-out synthetic val sequences (``make_synth_dataset``'s
``<data>/val``) as one recurrent clip through ``Engine``, and the report
gives the mean PSNR against the ground-truth HR of

- the model's recurrent output, and
- the TF1-bilinear x4 upscale of the LR input (the no-learning
  baseline),

both over the last 8 frames of each 10-frame sequence (the first two
warm the recurrent state).  ``--perceptual`` adds the VGG feature
cosine distance (the GAN's perceptual loss net, the registry's ``vgg``
at seed 0), ``--pingpong`` the mean L1 between
the forward pass and the backward pass of the ping-pong clip, in u8
steps.

    python -m joshupscale_torch.tools.eval_synth checkpoints/frvsr/best.npz \\
        [--data data] [--f32] [--u8-state] [--int8 [--calibrate]] \\
        [--arch quality|fast] [--perceptual] [--pingpong] [--save-png P] \\
        [--cpu]
    python -m joshupscale_torch.tools.eval_synth export/frvsr/package --package
    python -m joshupscale_torch.tools.eval_synth random --zero-init

WEIGHTS is a checkpoint of any layout (``load_trained_params``), a
package directory with ``--package``, or ``random``.  Runs on the card
unless ``--cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_engine(args, lr, device):
    """The engine the flags ask for, batch = the val sequences."""
    from joshupscale_torch.runtime.engine import Engine, create_runtime

    n_seq, _, h, w, _ = lr.shape
    if args.package:
        # The package is served as exported: a tier flag would be
        # silently ignored and its numbers misattributed.
        ignored = [flag for flag, on in (
            ("--int8", args.int8), ("--calibrate", args.calibrate),
            ("--u8-state", args.u8_state), ("--f32", args.f32),
            ("--zero-init", args.zero_init)) if on]
        if ignored:
            raise SystemExit(
                f"--package serves the package as exported; "
                f"{' '.join(ignored)} would be ignored -- bake the tier "
                f"into the package instead")
        return create_runtime(args.weights, batch_size=n_seq,
                              frame_size=(h, w), device=device)

    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.tools.val_data import arch_config

    config = arch_config(args.arch, h, w,
                         "float32" if args.f32 else "bfloat16")
    for net in ("flow", "generator"):
        config[net]["zero_init_tail"] = args.zero_init
    config["inference"]["u8_state"] = args.u8_state
    built = create_models(config, seed=0)["inference"]
    params = built.params
    if args.weights != "random":
        from joshupscale_torch.export.importer import load_trained_params

        # Raw, TrainState and GANTrainState layouts are detected.
        params = load_trained_params(args.weights, params)
    if args.int8:
        from joshupscale_torch.export.quantize import (
            calibrate,
            quantize_params_int8,
        )

        ranges = None
        if args.calibrate:
            cal = np.transpose(lr[:1], (1, 0, 2, 3, 4))
            ranges = calibrate(built.obj, params, cal, device=device)
            print(f"calibrated {len(ranges)} conv activation scales")
        params = quantize_params_int8(params, ranges=ranges)
    return Engine(built.obj, params, batch_size=n_seq, device=device)


def vgg_distance(pred_u8, ref_u8, device, chunk: int = 8) -> float:
    """Mean VGG feature cosine distance (``vgg_cosine_loss``) of u8
    frames (..., H, W, 3) against ``ref_u8``: the registry's ``vgg`` at
    seed 0."""
    import torch

    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.training.losses import vgg_cosine_loss
    from joshupscale_torch.training.trainer import to_device

    vgg = create_models({"vgg": {"name": "vgg"}}, seed=0)["vgg"]
    params = to_device(vgg.params, device)
    frames = pred_u8.reshape(-1, *pred_u8.shape[-3:])
    refs = ref_u8.reshape(-1, *ref_u8.shape[-3:])
    total = 0.0
    for i in range(0, len(frames), chunk):
        a, b = (torch.from_numpy(x[i:i + chunk].astype(np.float32) / 255
                                 - .5).to(device) for x in (frames, refs))
        with torch.no_grad():
            total += float(vgg_cosine_loss(vgg.apply(params, b),
                                           vgg.apply(params, a))) * len(a)
    return total / len(frames)


def pingpong_l1(eng, clip) -> float:
    """Mean L1 (u8 steps) between the forward pass at frame t and the
    backward pass of the ping-pong clip at the same content frame,
    frames 2 .. T-2."""
    t = len(clip)
    eng.reset()
    outs = eng.process_clip(np.concatenate([clip, clip[-2::-1]], axis=0))
    return float(np.mean([np.mean(np.abs(
        outs[ti].astype(np.float32) - outs[2 * t - 2 - ti].astype(
            np.float32))) for ti in range(2, t - 1)]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weights", help="train-state .npz checkpoint, model "
                    "package dir, or 'random'")
    ap.add_argument("--data", default="data")
    ap.add_argument("--gan", action="store_true",
                    help="accepted as the reference tool accepts it: the "
                         "checkpoint layout is detected")
    ap.add_argument("--package", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute (learning quality without bf16 "
                         "serving noise in the recurrent feedback)")
    ap.add_argument("--zero-init", action="store_true",
                    help="build with zero_init_tail (untrained model == "
                         "bilinear / identity-warp baseline: a check of "
                         "the evaluation, margin ~0)")
    ap.add_argument("--arch", choices=("quality", "fast"),
                    default="quality",
                    help="architecture the checkpoint was trained with "
                         "(quality: 64f/10rb + 64f/24rb; fast: 32f/6rb + "
                         "48f/12rb)")
    ap.add_argument("--int8", action="store_true",
                    help="serve the weights through the int8 tier "
                         "(export/quantize.py)")
    ap.add_argument("--calibrate", action="store_true",
                    help="with --int8: calibrate static activation scales "
                         "on the first val sequence first")
    ap.add_argument("--u8-state", action="store_true",
                    help="serve with the uint8 recurrent-state tier")
    ap.add_argument("--save-png", metavar="PATH",
                    help="write a strip (bilinear x4 | model | ground "
                         "truth, last frame of the first 3 sequences)")
    ap.add_argument("--perceptual", action="store_true",
                    help="also report the VGG feature cosine distance "
                         "against the ground truth")
    ap.add_argument("--pingpong", action="store_true",
                    help="also report the ping-pong inconsistency "
                         "(forward vs backward pass L1)")
    args = ap.parse_args(argv)

    from joshupscale_torch import resolve_device
    from joshupscale_torch.tools.val_data import (
        bilinear_x4_u8,
        load_sequences,
        psnr,
    )
    from joshupscale_torch.training.trainer import exact_float32

    device = resolve_device("cpu" if args.cpu else None)
    lr, hr = load_sequences(args.data)
    n_seq, t, h, w, _ = lr.shape
    print(f"val: {n_seq} sequences of {t} frames, {w}x{h} -> "
          f"{w * 4}x{h * 4}")

    clip = np.transpose(lr, (1, 0, 2, 3, 4))  # (T, N, H, W, 3), BGR u8
    with exact_float32():
        eng = build_engine(args, lr, device)
        outs = np.transpose(eng.process_clip(clip), (1, 0, 2, 3, 4))
    up_u8 = bilinear_x4_u8(lr, device)

    sl = slice(2, None)  # the zero-state warm-up frames
    p_model = psnr(outs[:, sl], hr[:, sl])
    p_bilinear = psnr(up_u8[:, sl], hr[:, sl])
    print(f"model    PSNR: {p_model:.2f} dB")
    print(f"bilinear PSNR: {p_bilinear:.2f} dB")
    print(f"margin: {p_model - p_bilinear:+.2f} dB")

    if args.perceptual:
        with exact_float32():
            v_model = vgg_distance(outs[:, sl], hr[:, sl], device)
            v_bilinear = vgg_distance(up_u8[:, sl], hr[:, sl], device)
        print(f"model    VGG cosine distance: {v_model:.4f}")
        print(f"bilinear VGG cosine distance: {v_bilinear:.4f}")
        print(f"perceptual margin: {(v_bilinear - v_model) / v_bilinear:+.1%}"
              " (lower distance is better)")

    if args.pingpong:
        with exact_float32():
            pp = pingpong_l1(eng, clip)
        print(f"ping-pong inconsistency: {pp:.3f} u8 steps "
              f"(mean L1, frames 2..{t - 2} vs backward pass)")

    if args.save_png:
        import cv2

        strip = np.concatenate([np.concatenate(
            [up_u8[i, -1], outs[i, -1], hr[i, -1]], axis=1)
            for i in range(min(3, n_seq))], axis=0)
        cv2.imwrite(args.save_png, strip)
        print(f"wrote {args.save_png} ({strip.shape[1]}x{strip.shape[0]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
