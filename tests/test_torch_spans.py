"""The serving engines' host spans (``runtime/spans.py``) and the stage
markers' layer rules (``models.common.STAGE_MARKS``) on the CPU.

Under a CPU ``torch.profiler`` session every engine call opens its
``engine.*`` spans, nested and in order; with no session ``span`` is a
shared no-op and no record is made.  The marked rules return what they
are given and, on the CPU, launch nothing.  The card's side (the marked
frame graph, the markers in a trace, the staging spans) is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from joshupscale_torch.kernels.markers import stage_end
from joshupscale_torch.models.common import STAGE_MARKS
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.parallel import (
    PipelinedEngine,
    ShardedEngine,
    SpatialEngine,
)
from joshupscale_torch.runtime import spans
from joshupscale_torch.runtime.engine import Engine, run_step

H, W = 16, 24


@pytest.fixture(scope="module")
def built():
    config = {
        "flow": {"name": "flow-resnet", "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": "float32"},
    }
    return create_models(config, seed=2)["inference"]


def _frames(n, batch=None):
    shape = (n, H, W, 3) if batch is None else (n, batch, H, W, 3)
    return np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)


def _engine_spans(fn):
    """The ``engine.*`` records that ``fn()`` makes under a CPU profiler
    session: [(name, start, end)] in order of start (ns)."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and e.name().startswith("engine.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _assert_nested(records):
    """Every record after the first lies inside the first."""
    _, start, end = records[0]
    for name, s, e in records[1:]:
        assert start <= s <= e <= end, name


CALL = ["engine.process", "engine.stage_copy", "engine.replay",
        "engine.readback"]


@pytest.mark.parametrize("call", ["process", "process_async", "reset"])
def test_engine_spans_nest_in_order(built, call):
    """``Engine`` on the CPU: ``process`` opens the call, the frame's
    copy into a tensor, the eager step and the readback, in that order;
    ``process_async`` the same without the readback; ``reset`` its own
    span.  (The CPU has no staging ring: ``engine.stage_wait`` and
    ``engine.h2d`` are the card's.)"""
    engine = Engine(built.obj, built.params, device="cpu")
    frame = _frames(1)[0]
    records = _engine_spans(lambda: getattr(engine, call)(
        *(() if call == "reset" else (frame,))))
    names = [r[0] for r in records]
    want = {"process": CALL, "process_async": CALL[:3],
            "reset": ["engine.reset"]}[call]
    assert names == want
    _assert_nested(records)
    # the sub-spans follow each other without overlapping
    for (_, _, end), (_, start, _) in zip(records[1:], records[2:]):
        assert end <= start


def test_sharded_engine_spans(built):
    """``ShardedEngine`` on two CPU entries: one ``engine.process`` over
    each engine's frame copy and step, then one readback of all streams;
    its ``reset`` spans each engine's."""
    sharded = ShardedEngine(built.obj, built.params, devices=["cpu", "cpu"])
    frames = _frames(1, batch=2)[0]
    names = [r[0] for r in _engine_spans(lambda: sharded.process(frames))]
    assert names == ["engine.process"] + [
        "engine.stage_copy", "engine.replay"] * 2 + ["engine.readback"]
    records = _engine_spans(sharded.reset)
    assert [r[0] for r in records] == ["engine.reset"] * 3
    _assert_nested(records)


def test_spatial_and_pipelined_engine_spans(built):
    """``SpatialEngine`` (two CPU slabs: the scatter is its ``h2d``) and
    ``PipelinedEngine`` (two CPU stages, ``ServingIO``'s spans) open the
    call's spans in order."""
    frame = _frames(1)[0]
    spatial = SpatialEngine(built.obj, built.params, devices=["cpu", "cpu"])
    records = _engine_spans(lambda: spatial.process(frame))
    assert [r[0] for r in records] == [
        "engine.process", "engine.stage_copy", "engine.h2d",
        "engine.replay", "engine.readback"]
    _assert_nested(records)
    assert spatial.frames_processed == 1
    piped = PipelinedEngine(built.obj, built.params, devices=["cpu", "cpu"])
    records = _engine_spans(lambda: piped.process(frame))
    assert [r[0] for r in records] == CALL
    _assert_nested(records)


def test_no_session_no_record(built, monkeypatch):
    """With no profiler session ``span`` hands back one shared no-op
    context, and an engine's calls make no profiler record at all."""
    assert not spans.profiling()
    assert spans.span("engine.process") is spans.span("engine.h2d")

    def refuse(name):
        raise AssertionError(f"a record {name!r} with no session")

    monkeypatch.setattr(spans, "_RECORD", refuse)
    engine = Engine(built.obj, built.params, device="cpu")
    frame = _frames(1)[0]
    engine.process(frame)
    engine.process_async(frame)
    engine.reset()
    assert engine.frames_processed == 1


def test_marking_only_while_profiling_outside_unmarked():
    """Replays run the marked graph only while a profiler session is
    active and no ``unmarked()`` block is open, nested blocks included;
    a block closed by an exception is closed."""
    assert not spans.marking()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.marking()
        with spans.unmarked():
            assert not spans.marking()
            with spans.unmarked():
                assert not spans.marking()
            assert not spans.marking()
        assert spans.marking()
        with pytest.raises(KeyError), spans.unmarked():
            raise KeyError("out")
        assert spans.marking()
    with spans.unmarked():
        assert not spans.marking()
    assert not spans.marking()


def test_marked_rules_return_their_input_and_launch_nothing_on_cpu(built):
    """``STAGE_MARKS.record`` returns the tensor it is given for every
    name (the three stage boundaries and the nets' own records); a
    marked CPU step equals the plain one bit for bit, and no marker is
    launched."""
    x = torch.arange(6.0).reshape(1, 2, 3)
    before = stage_end.launches
    for name in ("flow", "pre_warp", "output", "generator.conv_1"):
        assert STAGE_MARKS.record(name, x) is x
    model, params = built.obj, built.obj.prepare_params(built.params, "cpu")
    frames = torch.from_numpy(_frames(3))
    states = [model.init_state(1, device="cpu") for _ in range(2)]
    with torch.inference_mode():
        for f in frames:
            plain = run_step(model, params, f[None], states[0])
            marked = run_step(model, params, f[None], states[1], STAGE_MARKS)
            assert torch.equal(plain, marked)
    assert torch.equal(states[0]["pre_gen"], states[1]["pre_gen"])
    assert stage_end.launches == before


def test_ptxas_report_names_the_markers_by_themselves():
    """``kernels/_build.ptxas_rows`` (the per-kernel registers and
    spills that ``resource_usage`` reports for every CUDA source) names
    a mangled kernel by its demangled short name and the markers'
    ``extern "C"`` kernels, which ptxas reports unmangled, by their own
    names."""
    from joshupscale_torch.kernels._build import ptxas_rows

    log = "\n".join([
        "ptxas info    : Compiling entry function 'stage_end_flow' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 4 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_Z4convILi64EEvv' for "
        "'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : (C7511) Potential Performance Loss: wgmma "
        "serialized for the function '_Z4convILi64EEvv'",
    ])
    rows = ptxas_rows(log, {"_Z4convILi64EEvv": "conv<64>"})
    assert rows == [("stage_end_flow", 4, 0, []),
                    ("conv<64>", 168, 8, ["C7511 Potential Performance "
                                          "Loss: wgmma serialized"])]
