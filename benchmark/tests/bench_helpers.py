"""Helpers of the benchmark's CPU tests: throwaway checkouts that hold
tiny cells as files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY = (30, 48)  # LR frame; 30 rows pad to 32 on the autoencoder's ladder


def tiny_config(name: str, dtype: str = "bfloat16") -> dict:
    """The configuration file ``name`` at a tiny frame, its resnets cut to
    2 res blocks."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    models = cfg["models"]
    models["inference"].update(frame_height=TINY[0], frame_width=TINY[1],
                               compute_dtype=dtype)
    for net in ("flow", "generator"):
        if "num_res_blocks" in models[net]:
            models[net]["num_res_blocks"] = 2
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    mix.update(shot_frames=6, ring_frames=16, warmup_calls=2, trace_calls=3)
    mix["check"] = {"first_shot": 1, "shots_among": 2, "shots": 1,
                    "every": 2}
    return mix


def make_root(tmp: Path, cells, metrics=None) -> Path:
    """A checkout under ``tmp`` with the harness's code and data, tiny
    configurations and mixes, and ``cells``: [(cell, config, mix)]."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        (root / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    for mix in ("stream", "batch4"):
        (root / "benchmark" / "traffic" / f"{mix}.json").write_text(
            json.dumps(tiny_mix(mix)))
    limits = {k: {"limit": 1.3} for k in ("mean_abs_u8",
                                          "worst_frame_mean_abs_u8")}
    bench["workloads"] = []
    for cell, config, mix in cells:
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1, "why": "test"})
        path = root / "benchmark" / "limits" / f"{cell}.json"
        if not path.exists():  # the committed limits, else the same 1.3
            path.write_text(json.dumps(limits))
    names = [c[0] for c in cells]
    for m in bench["per_layer"]:
        m["workloads"] = names
    bench["per_layer"] += metrics or []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
