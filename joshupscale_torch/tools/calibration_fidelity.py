"""Compare the int8 calibrators: minmax against percentile against
entropy.

Port of ``tools/calibration_fidelity.py``: the same learned weights are
calibrated with each method on the first ``--cal-sequences`` rendered
val sequences; the remaining sequences are served as one recurrent clip
by each int8 engine and by the bf16 engine, and each calibrator gets its
u8 error against the bf16 engine (mean / p99 / max, the deployment
fidelity) and its PSNR against the ground truth (the quality), both on
held-out sequences.

    python -m joshupscale_torch.tools.calibration_fidelity \\
        checkpoints/frvsr/latest.npz [--data data] [--cal-sequences 4] \\
        [--percentile 99.9] [--arch quality|fast] [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def u8_stats(a: np.ndarray, b: np.ndarray):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float(d.mean()), int(np.percentile(d, 99)), int(d.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weights", help="train-state .npz checkpoint")
    ap.add_argument("--data", default="data")
    ap.add_argument("--cal-sequences", type=int, default=4)
    ap.add_argument("--percentile", type=float, default=99.9)
    ap.add_argument("--gan", action="store_true",
                    help="accepted as the reference tool accepts it: the "
                         "checkpoint layout is detected")
    ap.add_argument("--arch", choices=("quality", "fast"),
                    default="quality")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    from joshupscale_torch.export.quantize import (
        calibrate,
        quantize_params_int8,
    )
    from joshupscale_torch.runtime.engine import Engine
    from joshupscale_torch.tools.generate_calibration import load_model
    from joshupscale_torch.tools.val_data import load_sequences, psnr

    device = "cpu" if args.cpu else None
    lr, hr = load_sequences(args.data)
    n_seq, t, h, w, _ = lr.shape
    n_cal = args.cal_sequences
    if not 0 < n_cal < n_seq:
        raise ValueError(f"--cal-sequences {n_cal} must leave held-out "
                         f"sequences of the {n_seq}")
    cal_clip = np.transpose(lr[:n_cal], (1, 0, 2, 3, 4))
    eval_lr, eval_hr = lr[n_cal:], hr[n_cal:]
    n_eval = eval_lr.shape[0]
    eval_clip = np.transpose(eval_lr, (1, 0, 2, 3, 4))
    print(f"calibrate on {n_cal} sequences, evaluate on {n_eval} "
          f"({t} frames, {w}x{h} -> {w * 4}x{h * 4})")

    model, params = load_model(args.weights, h, w, False, args.arch,
                               compute_dtype="bfloat16")

    # The fidelity reference: the bf16 engine on the same clip.
    ref_outs = Engine(model, params, batch_size=n_eval,
                      device=device).process_clip(eval_clip)
    sl = slice(2, None)  # skip the zero-state warm-up frames
    p_ref = psnr(np.transpose(ref_outs, (1, 0, 2, 3, 4))[:, sl],
                 eval_hr[:, sl])
    print(f"bf16 engine held-out PSNR: {p_ref:.2f} dB")

    rows = []
    for method, pct in (("minmax", 100.0), ("percentile", args.percentile),
                        ("entropy", 100.0)):
        ranges = calibrate(model, params, cal_clip, percentile=pct,
                           method=method, device=device)
        qparams = quantize_params_int8(params, ranges=ranges)
        outs = Engine(model, qparams, batch_size=n_eval,
                      device=device).process_clip(eval_clip)
        mean, p99, mx = u8_stats(outs[2:], ref_outs[2:])
        p_q = psnr(np.transpose(outs, (1, 0, 2, 3, 4))[:, sl],
                   eval_hr[:, sl])
        rows.append((method, pct, mean, p99, mx, p_q))
        print(f"{method:<10} (pct {pct:5.1f}): vs bf16 mean "
              f"{mean:.3f} / p99 {p99} / max {mx} u8 steps; "
              f"PSNR {p_q:.2f} dB ({p_q - p_ref:+.2f})")

    print()
    print("| Calibrator | u8 error vs bf16 engine (mean/p99/max) | "
          "held-out PSNR |")
    print("|---|---|---|")
    for method, pct, mean, p99, mx, p_q in rows:
        name = (f"{method} ({pct:g}%)" if method == "percentile"
                else method)
        print(f"| {name} | {mean:.3f} / {p99} / {mx} | "
              f"{p_q:.2f} dB ({p_q - p_ref:+.2f} vs bf16) |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
