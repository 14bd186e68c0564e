"""The learning protocol: does the FRVSR trainer learn on the card?

Renders the synthetic set (``make_synth_dataset``, ``--train`` /
``--val`` sequences from ``--source``), trains ``--config`` (default
``configs/frvsr_synth_learn.yaml``; a copy in ``--out`` with
``--epochs`` x ``--steps`` and its data, checkpoint and export paths
moved under ``--out``) through the training CLI, recalibrates the best
checkpoint's batch-norm statistics (``bn_recalibrate``), then runs
``eval_synth`` on the checkpoint before and after recalibration, on a
zero-tail model and on random init, each in bf16 and with ``--f32``:
held-out PSNR against bilinear x4.  The report is printed and written
to ``<out>/learning.json``.

    python -m joshupscale_torch.tools.learning_run --out runs/learn \\
        [--epochs 10] [--steps 150] [--train 200] [--val 20] \\
        [--source docs/learned_compare.png] [--config C] [--cpu]

Runs on the card unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

from joshupscale_torch.tools.make_synth_dataset import DEF_SOURCE, REPO
from joshupscale_torch.tools.val_data import report_psnrs


def run_tool(name, argv, echo=print):
    """``joshupscale_torch.tools.<name>.main(argv)`` in this process, its
    standard output captured and passed to ``echo`` line by line:
    returns (output, seconds).  A non-zero exit raises."""
    import importlib

    main = importlib.import_module(f"joshupscale_torch.tools.{name}").main
    argv = [str(a) for a in argv]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        echo(line)
    if rc != 0:
        raise RuntimeError(f"{name} {' '.join(argv)} exited {rc}")
    return text, seconds


def learning_config(config, data, out, epochs, steps):
    """The training config with ``epochs`` x ``steps``, its ``data/``
    paths under ``data`` and its outputs under ``out``."""
    config = json.loads(json.dumps(config))
    for key in ("train_dataset", "val_dataset"):
        for op in config.get(key, []):
            for k in ("lr_path", "hr_path"):
                if k in op:
                    op[k] = os.path.join(data, op[k].split("data/", 1)[-1])
    train = config["train"]
    train.update(epochs=epochs, steps_per_epoch=steps,
                 checkpoint_dir=os.path.join(out, "ckpt"),
                 log_dir=os.path.join(out, "ckpt"))
    if "export" in config:
        config["export"]["dir"] = os.path.join(out, "export")
    return config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "frvsr_synth_learn.yaml"))
    ap.add_argument("--source", default=DEF_SOURCE)
    ap.add_argument("--train", type=int, default=200)
    ap.add_argument("--val", type=int, default=20)
    ap.add_argument("--hr-size", type=int, default=192)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args(argv)

    from joshupscale_torch import resolve_device
    from joshupscale_torch.training import cli

    resolve_device("cpu" if args.cpu else None)
    data = os.path.join(args.out, "data")
    report = {"args": vars(args)}
    cpu = ["--cpu"] if args.cpu else []
    _, report["render_s"] = run_tool("make_synth_dataset", [
        data, "--source", args.source, "--train", args.train, "--val",
        args.val, "--hr-size", args.hr_size])

    config = learning_config(cli.load_config(args.config), data, args.out,
                             args.epochs, args.steps)
    config_path = os.path.join(args.out, "learn.yaml")
    with open(config_path, "w") as f:
        json.dump(config, f, indent=1)  # JSON is YAML
    t0 = time.perf_counter()
    rc = cli.main(["-c", config_path] + cpu)
    report["train_s"] = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"training exited {rc}")
    with open(os.path.join(args.out, "ckpt", "history.json")) as f:
        report["history"] = json.load(f)

    best = os.path.join(args.out, "ckpt", "best.npz")
    bncal = os.path.join(args.out, "ckpt", "best_bncal.npz")
    _, report["bn_recalibrate_s"] = run_tool("bn_recalibrate", [
        best, "-c", config_path, "-o", bncal] + cpu)

    rows = []
    for label, flags in (("trained", [best]), ("trained + BN recal", [bncal]),
                         ("zero tail", ["random", "--zero-init"]),
                         ("random init", ["random"])):
        for dtype in ("bfloat16", "float32"):
            text, seconds = run_tool("eval_synth", flags + [
                "--data", data] + (["--f32"] if dtype == "float32" else [])
                + cpu)
            model_db, bilinear_db = report_psnrs(text)
            rows.append({"weights": label, "dtype": dtype,
                         "model_db": model_db, "bilinear_db": bilinear_db,
                         "seconds": seconds})
    report["eval"] = rows
    print("| weights | compute | model dB | bilinear x4 dB | margin |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['weights']} | {r['dtype']} | {r['model_db']:.2f} | "
              f"{r['bilinear_db']:.2f} | "
              f"{r['model_db'] - r['bilinear_db']:+.2f} |")
    print(f"train {report['train_s']:.1f} s for {args.epochs} x "
          f"{args.steps} steps")
    with open(os.path.join(args.out, "learning.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
