"""The readings the check's limits are set from, on the card, in one
process a cell.

    python3 benchmark/tools/readings.py --workload <cell> \\
        --seeds 12 --control-seeds 3 [--seconds 1.5] [--int8-seeds 3]

- lower: the program's own runs (``runner.run_cell``, the timed path at
  the cell's size and load, a short window) on ``--seeds`` seeds;
- upper: the control, the plain reference put in the program's place
  and computed through float8 e4m3 (the precision below the
  configuration's bfloat16), on ``--control-seeds`` seeds, compared with
  the float32 reference as the program's frames are;
- the program's own int8 path (``export/quantize.py``, dynamic scales)
  on ``--int8-seeds`` seeds, for the record.

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path[:0] = [str(HERE.parent), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--int8-seeds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose files name the cell")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (numbers of no device)")
    args = ap.parse_args(argv)

    from run import cache_env
    os.environ.update(cache_env(ROOT))
    import torch

    from benchlib import check
    from benchlib.runner import program, run_cell
    from benchlib.spec import load_cell
    from benchlib.traffic import make_ring
    from benchlib.weights import seeded_params

    if args.cpu:
        device, kind = torch.device("cpu"), "cpu"
    elif not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda:0")
        kind = torch.cuda.get_device_name(0)
    cell = load_cell(Path(args.root), args.workload)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    seeds = [args.first_seed + 7919 * i for i in range(
        max(args.seeds, args.control_seeds, args.int8_seeds))]
    for seed in seeds[:args.seeds]:
        res = run_cell(cell, seed, args.seconds, False, device,
                       time.monotonic(), kind=kind)
        emit({"reading": "program", "cell": cell.name, "seed": seed,
              "numbers": {k: v["value"] for k, v in res["compared"].items()},
              "metrics": {k: v["value"] for k, v in res["metrics"].items()}})

    def int8_system(cell_, model, params, dev):
        from joshupscale_torch.export.quantize import quantize_params_int8
        from joshupscale_torch.runtime.engine import Engine

        return Engine(model, quantize_params_int8(params), device=dev)

    for seed in seeds[:args.int8_seeds]:
        res = run_cell(cell, seed, args.seconds, False, device,
                       time.monotonic(), system_factory=int8_system,
                       kind=kind)
        emit({"reading": "program_int8", "cell": cell.name, "seed": seed,
              "numbers": {k: v["value"] for k, v in res["compared"].items()}})

    mix, models = cell.traffic, cell.config["models"]
    inf = models["inference"]
    h, w = inf["frame_height"], inf["frame_width"]
    pan_hr = [4 * v for v in mix["pan_lr_px_per_frame"]]
    for seed in seeds[:args.control_seeds]:
        t0 = time.monotonic()
        params = seeded_params(program(cell)[1], models,
                               cell.config["weights"], pan_hr, seed, device)
        ring = make_ring(mix, seed, h, w, device)
        kept = check.kept_calls(mix, seed)
        served, _ = check.reference_frames(
            cell.reference, models, params, ring, mix, kept, device,
            rounding=torch.float8_e4m3fn)
        numbers, notes = check.compare(cell.reference, models, params, ring,
                                       mix, kept, served, device)
        emit({"reading": "control_fp8", "cell": cell.name, "seed": seed,
              "numbers": numbers, "seconds": time.monotonic() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
