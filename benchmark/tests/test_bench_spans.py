"""The readers of the program's own spans and stage markers
(``benchlib/calls.py``) on synthetic traces: the engine's launch and
readback, the flow, warp and generator stages, and nothing where the
program makes no span or marker (a parent without them, the CPU)."""

from __future__ import annotations

import pytest

from bench_helpers import BENCH
from benchlib.spec import load_module
from benchlib.trace import Trace

NAMES = ("engine.launch_ms", "engine.readback_ms", "stage.flow_ms",
         "stage.warp_ms", "stage.generator_ms")
MARKERS = ("stage_end_flow", "stage_end_warp", "stage_end_generator")


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"spans_{name}")


def read(tr, name):
    return metric(name).read(tr, {})


def rec(name, ts, dur, kind=None):
    out = {"name": name, "ts": float(ts), "dur": float(dur)}
    return dict(out, kind=kind) if kind else out


def synthetic(spans=True, markers=True, streams=1, cpu=False):
    """Two calls of 1000 us, 200 us apart.  Host: the call's span, then
    ``engine.process`` (10-990) over the staging wait, copy and input
    copy (20-70), the replay (70-100) and the readback (100-980).
    Card: the input copy (55, 10), the preprocess (110, 40 us) and a flow conv (150, 200), the
    flow marker (350, 5), the gather (360, 100), the warp marker (460,
    5), a generator conv (470, 300), the generator marker (770, 5), the
    state commit (780, 20), K2 (800, 10) and the output copy (810,
    150).  ``cpu``: the card's records are ATen ops, as in a rehearsal
    on the CPU."""
    device, calls, host = [], [], []
    for t in (0.0, 1200.0):
        calls.append(rec("bench.call", t, 1000))
        if spans:
            host += [rec("engine.process", t + 10, 980),
                     rec("engine.stage_wait", t + 20, 10),
                     rec("engine.stage_copy", t + 30, 20),
                     rec("engine.h2d", t + 50, 20),
                     rec("engine.replay", t + 70, 30),
                     rec("cudaGraphLaunch", t + 75, 20),
                     rec("engine.readback", t + 100, 880)]
        work = [("void at::native::vectorized_elementwise_kernel", 110, 40),
                ("void resblock_conv3x3_bf16<64>", 150, 200),
                ("void at::native::index_elementwise_kernel", 360, 100),
                ("void resblock_conv3x3_bf16<64>", 470, 300),
                ("void at::native::vectorized_elementwise_kernel", 780, 20),
                ("d2s_display_u8_kernel", 800, 10)]
        if markers:
            work += [(m, at, 5) for m, at in zip(MARKERS, (350, 460, 770))]
        for name, at, dur in work:
            device.append(rec(f"aten::op{at}" if cpu else name, t + at, dur,
                              "kernel"))
        device.append(rec("Memcpy HtoD (Pinned -> Device)", t + 55, 10,
                          "memcpy"))
        device.append(rec("Memcpy DtoH (Device -> Pageable)", t + 810, 150,
                          "memcpy"))
    return Trace(device, calls, calls + host, streams)


def test_readers_on_spans_and_markers():
    tr = synthetic()
    assert read(tr, "engine.launch_ms") == pytest.approx(0.090)
    assert read(tr, "engine.readback_ms") == pytest.approx(0.170)
    assert read(tr, "stage.flow_ms") == pytest.approx(0.240)
    assert read(tr, "stage.warp_ms") == pytest.approx(0.100)
    assert read(tr, "stage.generator_ms") == pytest.approx(0.300)


def test_stages_and_the_tail_add_up_to_the_step():
    """The three stages, the kernels after the generator marker (state
    commit and K2) and the markers' own time are the step's busy time;
    the launch, the graph's way to its first kernel, the kernels and
    the readback are the engine's call up to the readback's end."""
    tr = synthetic()
    stages = sum(read(tr, n) for n in NAMES[2:])
    tail_ms, markers_ms = 0.030, 0.015
    step = metric("step.busy_ms").read(tr, {})
    assert stages + tail_ms + markers_ms == pytest.approx(step)
    first_kernel, last_kernel = 110.0, 810.0
    call = (read(tr, "engine.launch_ms") + (first_kernel - 100.0) / 1e3
            + (last_kernel - first_kernel) / 1e3
            + read(tr, "engine.readback_ms"))
    assert call == pytest.approx((980.0 - 10.0) / 1e3)


def test_stages_are_per_frame():
    one, two = synthetic(), synthetic(streams=2)
    for name in NAMES[2:]:
        assert read(two, name) == pytest.approx(read(one, name) / 2)
    for name in NAMES[:2]:  # a call's host time, whatever its frames
        assert read(two, name) == pytest.approx(read(one, name))


def test_no_markers_no_stages():
    """A program without markers (the parent, an engine that replays
    the plain graph) gives no stage; the spans still give the host's
    two parts."""
    tr = synthetic(markers=False)
    for name in NAMES[2:]:
        assert read(tr, name) is None
    assert read(tr, "engine.launch_ms") == pytest.approx(0.090)
    # the last kernel is K2 now, as before: the markers come earlier
    assert read(tr, "engine.readback_ms") == pytest.approx(0.170)


def test_no_spans_no_host_parts():
    tr = synthetic(spans=False)
    for name in NAMES[:2]:
        assert read(tr, name) is None
    assert read(tr, "stage.warp_ms") == pytest.approx(0.100)


def test_cpu_rehearsal_reads_nothing():
    """On the CPU the device records are the host's ATen ops: no card
    kernel, no marker, so no reader has anything to read."""
    tr = synthetic(cpu=True)
    for name in NAMES:
        assert read(tr, name) is None


def test_calls_without_a_marker_are_left_out():
    """A call whose warp marker is missing counts in no stage that ends
    or starts there; the other call still gives the stage."""
    tr = synthetic()
    tr.device = [e for e in tr.device
                 if not (e["name"] == "stage_end_warp" and e["ts"] < 1000)]
    assert read(tr, "stage.warp_ms") == pytest.approx(0.100)
    assert read(tr, "stage.generator_ms") == pytest.approx(0.300)
    assert read(tr, "stage.flow_ms") == pytest.approx(0.240)


def test_calls_with_markers_repeated_or_out_of_order_are_left_out():
    """A call that holds a marker twice, or its markers out of stage
    order (records that fell into the wrong call), is left out by every
    reader; the other call still gives each metric."""
    from benchlib.calls import calls

    for moved in (("stage_end_flow", 600.0), ("stage_end_warp", 300.0)):
        tr = synthetic()
        extra = dict(next(e for e in tr.device if e["name"] == moved[0]),
                     ts=moved[1])
        if moved[0] == "stage_end_flow":
            tr.device.append(extra)  # a second flow marker in call 1
        else:
            tr.device = [extra if e["name"] == moved[0] and e["ts"] < 1000
                         else e for e in tr.device]  # warp before flow
        assert read(tr, "stage.flow_ms") == pytest.approx(0.240)
        assert read(tr, "stage.warp_ms") == pytest.approx(0.100)
        assert read(tr, "stage.generator_ms") == pytest.approx(0.300)


@pytest.mark.parametrize("shift", [100.0, -80.0])
def test_calls_whose_card_records_lie_outside_their_spans_are_left_out(
        shift):
    """A call whose card records all lie ``shift`` us off the host's
    (a clock set off in the trace) is left out by every reader: late,
    its copy out ends after the readback; early, its copy in falls
    before the call, so its first record is a kernel.  Counted, the
    late call would read a readback of 0.070 ms, the early one 0.250."""
    from benchlib.calls import calls

    tr = synthetic()
    tr.device = [dict(e, ts=e["ts"] + shift) if e["ts"] < 1000 else e
                 for e in tr.device]
    assert [c.whole for c in calls(tr, every=True)] == [False, True]
    assert len(calls(tr)) == 1
    assert read(tr, "engine.launch_ms") == pytest.approx(0.090)
    assert read(tr, "engine.readback_ms") == pytest.approx(0.170)
    assert read(tr, "stage.flow_ms") == pytest.approx(0.240)
    assert read(tr, "stage.warp_ms") == pytest.approx(0.100)
    assert read(tr, "stage.generator_ms") == pytest.approx(0.300)


def test_split_tool_reconciles_a_call_and_a_step():
    """``tools/split.py`` on the synthetic trace: the call's parts add up
    to its span, the stages, the tail and the markers to the step's
    busy time, and the host time outside the sub-spans is what the
    synthetic calls leave (10-20 and 980-990 us)."""
    tool = load_module(BENCH / "tools" / "split.py", "spans_split_tool")
    tr = synthetic()
    metrics = {n: {"value": read(tr, n)} for n in NAMES}
    metrics["step.busy_ms"] = {"value": metric("step.busy_ms").read(tr, {})}
    out = tool.split(tr, metrics)
    call = out["call"]
    assert [call[k] for k in ("launch", "to_first_kernel", "kernels",
                              "readback", "rest")] == pytest.approx(
        [0.090, 0.010, 0.700, 0.170, 0.030])
    assert sum(v for k, v in call.items() if k != "span") == pytest.approx(
        call["span"])
    step = out["step"]
    assert step["after_generator"] == pytest.approx(0.030)
    assert step["sum"] == pytest.approx(step["busy"])
    assert out["host"]["uncovered_us"] == pytest.approx(20.0)
    assert out["launch_parts"] == pytest.approx({"before_replay": 0.060,
                                                 "replay": 0.030})
    assert out["dropped"] == {"calls": 0, "of": 2, "offsets_us": []}
    assert out["gaps"] == []  # no idle gap inside a call passes 200 us
