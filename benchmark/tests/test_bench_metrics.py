"""The yardstick's arithmetic on synthetic traces: the end-to-end
metrics over every frame of the window, busy and idle time, the
per-layer readers, the roofline and the FLOPs counted from shapes."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from bench_helpers import BENCH
from benchlib import flops, stats
from benchlib.spec import load_module
from benchlib.trace import Trace, kernel_group

H100 = flops.PEAKS["H100"]


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"test_{name}")


def k(name, ts, dur, kind="kernel"):
    return {"name": name, "ts": float(ts), "dur": float(dur), "kind": kind}


def synthetic(streams=1):
    """Two calls of 1000 us, 200 us apart; in each: a res-block conv
    (200 us), the warp's gather (100), an elementwise pass (300), the
    output copy (200)."""
    device, spans, host = [], [], []
    for t in (0.0, 1200.0):
        spans.append({"name": "bench.call", "ts": t, "dur": 1000.0})
        device += [k("void resblock_conv3x3_bf16<64>", t + 100, 200),
                   k("void at::native::index_elementwise_kernel", t + 300,
                     100),
                   k("void at::native::vectorized_elementwise_kernel",
                     t + 400, 300),
                   k("Memcpy DtoH (Device -> Pageable)", t + 700, 200,
                     "memcpy")]
    host = spans + [{"name": "aten::copy_", "ts": 50.0, "dur": 100.0}]
    return Trace(device, spans, host, streams)


CTX = {"peaks": H100, "dtype": "bfloat16", "flops_per_frame": 1e12,
       "resblock_convs": [(1, 270, 480, 64, False)]}


def test_end_to_end_over_every_frame():
    lat = [0.010] * 90 + [0.020] * 10
    one = stats.end_to_end(lat, 1, 2.0, 12.5)
    assert one["fps"]["value"] == pytest.approx(50.0)
    assert one["frame_ms.p95"]["value"] == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert one["setup_s"]["value"] == 12.5
    # a batched call: each of its frames takes the call's latency
    four = stats.end_to_end(lat, 4, 2.0, 1.0)
    assert four["fps"]["value"] == pytest.approx(200.0)
    assert four["frame_ms.p95"]["value"] == pytest.approx(
        np.percentile(np.repeat(lat, 4), 95) * 1e3)
    # the tail is of all the frames, not of chunk medians
    assert stats.percentile(list(range(101)), 95) == 95.0


def test_busy_idle_and_gaps():
    tr = synthetic()
    assert (tr.t0, tr.t1, tr.calls, tr.frames) == (0.0, 2200.0, 2, 2)
    assert tr.busy_us() == pytest.approx(1600.0)
    assert tr.busy_us(("kernel",)) == pytest.approx(1200.0)
    gaps = tr.idle_gaps()
    assert gaps[0] == (900.0, 400.0)
    assert sorted(g[1] for g in gaps) == [100.0, 100.0, 400.0]
    assert tr.label(1050.0) == "between calls"
    assert tr.label(50.0) == "bench.call > aten::copy_"
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["other elementwise", pytest.approx(6e-4)]
    assert bd["idle_gaps"][0] == ["between calls", pytest.approx(4e-4)]


def test_overlapping_records_count_once():
    spans = [{"name": "bench.call", "ts": 0.0, "dur": 100.0}]
    dev = [k("a_conv3x3", 0, 60), k("elementwise", 40, 40)]
    tr = Trace(dev, spans, spans, 1)
    parts = tr.parts_ms()
    assert parts == {"K1 resblock_conv3x3": pytest.approx(0.06),
                     "other elementwise": pytest.approx(0.02)}
    assert tr.busy_us() == pytest.approx(80.0)


def test_per_layer_readers():
    tr = synthetic()
    read = lambda name: metric(name).read(tr, CTX)  # noqa: E731
    assert read("device.idle_share") == pytest.approx(100 * (1 - 16 / 22))
    assert read("step.busy_ms") == pytest.approx(0.6)
    assert read("engine.host_ms") == pytest.approx(0.2)
    assert read("elementwise_ms") == pytest.approx(0.3)
    assert read("warp.gather_ms") == pytest.approx(0.1)
    assert read("step_mfu") == pytest.approx(
        100 * 1e12 * 2 / (2200e-6 * 989e12))
    bound = flops.resblock_bound_s(1, 270, 480, 64, False, H100)
    assert read("resblock_conv_roofline") == pytest.approx(
        100 * bound / 200e-6)


def test_readers_find_nothing_return_nothing():
    spans = [{"name": "bench.call", "ts": 0.0, "dur": 100.0}]
    tr = Trace([k("elementwise", 0, 50)], spans, spans, 1)
    assert metric("warp.gather_ms").read(tr, CTX) is None
    assert metric("resblock_conv_roofline").read(tr, CTX) is None
    no_peaks = dict(CTX, peaks=None)
    assert metric("step_mfu").read(synthetic(), no_peaks) is None


def test_every_metric_file_matches_benchmark_json():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = metric(m["name"])
        assert (mod.name, mod.unit, mod.layer, mod.moves) == (
            m["name"], m["unit"], m["layer"], m["moves"])


def test_resblock_bound_matches_the_ports_arithmetic():
    """9.9 / 14.9 us for conv_1 / conv_2 at (1, 270, 480, 64): bytes."""
    c1 = flops.resblock_bound_s(1, 270, 480, 64, False, H100)
    c2 = flops.resblock_bound_s(1, 270, 480, 64, True, H100)
    assert c1 * 1e6 == pytest.approx(9.926, abs=1e-3)
    assert c2 * 1e6 == pytest.approx(14.878, abs=1e-3)


def test_flops_from_shapes():
    q = json.loads((BENCH / "configs" / "quality.json").read_text())["models"]
    hw = 270 * 480
    conv = lambda n, k, ci, co: 2.0 * n * k * k * ci * co  # noqa: E731
    want = (conv(hw, 3, 12, 64) + 20 * conv(hw, 3, 64, 64)
            + conv(hw, 1, 64, 32) + conv(hw, 3, 51, 64)
            + 48 * conv(hw, 3, 64, 64) + conv(hw, 1, 64, 128)
            + conv(4 * hw, 1, 32, 12))
    assert flops.model_flops_per_frame(q) == pytest.approx(want)
    assert len(flops.resblock_convs(q, 1)) == 68
    p = json.loads((BENCH / "configs" / "ps2_style.json").read_text())[
        "models"]
    assert len(flops.resblock_convs(p, 4)) == 48
    # the autoencoder's ladder at 272 x 480, halved three times and back
    ladder = [(12, 32, 1), (32, 64, 2), (64, 128, 4), (128, 256, 8),
              (256, 128, 4), (128, 64, 2)]
    ae = sum(conv(272 * 480 / s / s, 3, ci, co) + conv(
        272 * 480 / s / s, 3, co, co) for ci, co, s in ladder)
    ae += conv(272 * 480, 3, 64, 32) + conv(272 * 480, 3, 32, 32)
    gen = want - (conv(hw, 3, 12, 64) + 20 * conv(hw, 3, 64, 64)
                  + conv(hw, 1, 64, 32))
    assert flops.model_flops_per_frame(p) == pytest.approx(ae + gen)
    assert math.isclose(flops.model_flops_per_frame(q) / 1e9, 662.208,
                        rel_tol=1e-5)


def test_kernel_groups():
    assert kernel_group("resblock_conv3x3_kernel<64, true>") == \
        "K1 resblock_conv3x3"
    assert kernel_group("d2s_display_u8_kernel") == "K2 d2s_display_u8"
    assert kernel_group("void at::native::index_elementwise_kernel<128>") \
        == "warp row gather (index)"
    assert kernel_group("sm90_xmma_fprop_implicit_gemm") == "library convs"
