"""Generate int8 activation-calibration ranges from real frames.

Port of ``tools/generate_calibration.py``: streams the first
``--sequences`` rendered val sequences through the recurrent model, the
state carried frame to frame, records each conv input's range
(``export.quantize.calibrate``: minmax, percentile or entropy) and
writes the ranges JSON that both int8 doors take:
``quantize_params_int8(params, ranges=...)`` and ``export_onnx(...,
int8_ranges=...)``.

    python -m joshupscale_torch.tools.generate_calibration \\
        checkpoints/x/latest.npz --out ranges.json [--data data] \\
        [--sequences 4] [--percentile 99.9] [--method entropy] \\
        [--arch quality|fast] [--cpu]
    python -m joshupscale_torch.tools.generate_calibration export/pkg \\
        --package --out ranges.json ...

WEIGHTS is a checkpoint of any layout (``load_trained_params``), a
package directory with ``--package``, or ``random``.  Runs on the card
unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def load_model(weights: str, h: int, w: int, package: bool, arch: str,
               compute_dtype=None):
    """``(InferenceModel, params)`` at ``h`` x ``w``: a package's, or
    ``arch``'s seeded build with ``weights`` loaded (``random``: none)."""
    if package:
        from joshupscale_torch.export.package import load_package

        model, params = load_package(weights)
        return dataclasses.replace(model, frame_height=h,
                                   frame_width=w), params
    from joshupscale_torch.export.importer import load_trained_params
    from joshupscale_torch.models.registry import create_models
    from joshupscale_torch.tools.val_data import arch_config

    built = create_models(arch_config(arch, h, w, compute_dtype),
                          seed=0)["inference"]
    params = built.params
    if weights != "random":
        params = load_trained_params(weights, params)
    return built.obj, params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weights", help="train-state .npz, package dir, or "
                    "'random'")
    ap.add_argument("--out", required=True, help="ranges JSON path")
    ap.add_argument("--data", default="data")
    ap.add_argument("--sequences", type=int, default=4,
                    help="number of val sequences to stream")
    ap.add_argument("--percentile", type=float, default=100.0)
    ap.add_argument("--method", choices=("minmax", "percentile",
                                         "entropy"), default=None,
                    help="calibrator; default: minmax, or percentile when "
                         "--percentile < 100")
    ap.add_argument("--gan", action="store_true",
                    help="accepted as the reference tool accepts it: the "
                         "checkpoint layout is detected")
    ap.add_argument("--package", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    ap.add_argument("--arch", choices=("quality", "fast"),
                    default="quality")
    args = ap.parse_args(argv)

    from joshupscale_torch.export.quantize import calibrate
    from joshupscale_torch.tools.val_data import load_sequences

    lr, _ = load_sequences(args.data)
    lr = lr[: args.sequences]
    n_seq, t, h, w, _ = lr.shape
    model, params = load_model(args.weights, h, w, args.package, args.arch)
    ranges = calibrate(model, params, np.transpose(lr, (1, 0, 2, 3, 4)),
                       percentile=args.percentile, method=args.method,
                       device="cpu" if args.cpu else None)
    with open(args.out, "w") as f:
        json.dump({k: float(v) for k, v in ranges.items()}, f, indent=1,
                  sort_keys=True)
    print(f"wrote {len(ranges)} activation ranges to {args.out} "
          f"(streamed {n_seq}x{t} frames at {w}x{h}, "
          f"method {args.method or 'auto'}, "
          f"percentile {args.percentile})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
