"""A configuration, a traffic mix and a per-layer metric are added as new
files only, and the harness runs them."""

from __future__ import annotations

import json

import pytest

from bench_helpers import make_root, tiny_config
from benchlib.runner import run_cell
from benchlib.spec import load_cell

METRIC = '''"""Traced calls a second of the traced stretch."""

name = "calls_per_s"
unit = "calls/s"
layer = "serving I/O (runtime/engine.py ServingIO, parallel/serving.py)"
moves = "fps"


def read(trace, ctx):
    return trace.calls / (trace.window_us / 1e6)
'''


@pytest.mark.parametrize("trace", [False, True])
def test_added_files_run(tmp_path, trace):
    entry = {"name": "calls_per_s", "unit": "calls/s", "better": "higher",
             "source": "device_trace",
             "layer": "serving I/O (runtime/engine.py ServingIO, "
                      "parallel/serving.py)",
             "moves": "fps", "workloads": ["narrow.fast_pan"]}
    root = make_root(tmp_path, [("narrow.fast_pan", "narrow", "fast_pan")],
                     metrics=[entry])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = tiny_config("quality")
    cfg["name"] = "narrow"
    cfg["models"]["generator"]["num_filters"] = 48
    (root / "benchmark" / "configs" / "narrow.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "narrow", "source": "https://x.org/y",
                             "file": "benchmark/configs/narrow.json",
                             "reduced": [], "why": "test"})
    mix = json.loads((root / "benchmark" / "traffic" / "stream.json")
                     .read_text())
    mix["pan_lr_px_per_frame"] = [-1.0, 3.0]
    (root / "benchmark" / "traffic" / "fast_pan.json").write_text(
        json.dumps(mix))
    (root / "benchmark" / "metrics" / "calls_per_s.py").write_text(METRIC)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(root, "narrow.fast_pan")
    assert cell.traffic["pan_lr_px_per_frame"] == [-1.0, 3.0]
    res = run_cell(cell, 2**31 + 5, 0.3, trace, "cpu", 0.0)
    assert res["correct"]
    if trace:
        assert res["metrics"]["calls_per_s"]["value"] > 0
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert set(res["metrics"]) == {"fps", "frame_ms.p95", "setup_s"}
    assert list(res)[-1] == "compared"
