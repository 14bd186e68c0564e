"""Port parity for the serving runtime around the engine: ``VideoStream``,
``process_async``, ``benchmark``, ``debug_report``, ``save_package`` /
``to_flat_numpy``, ``NativeEngine`` and the CLI, against the JAX package
on the CPU.

16x24 LR frames, f32, u8 outputs within 1 step of the reference.  The
stream's nets are 32 filters x 1 res block, where the JAX stream test
takes 8 filters: the port's res-block conv takes 32, 48 or 64 channels.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import engine_factory, flat_params, u8_diff, u8_frames
from joshupscale_tpu.export.importer import flatten_params
from joshupscale_tpu.export.package import load_package as j_load_package
from joshupscale_tpu.runtime import cli as j_cli
from joshupscale_tpu.runtime.engine import Engine as JEngine
from joshupscale_tpu.runtime.native_glue import NativeEngine as JNativeEngine
from joshupscale_tpu.runtime.stream import VideoStream as JVideoStream
from joshupscale_torch.export.package import save_package
from joshupscale_torch.export.weights import from_flat_numpy, to_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.runtime import VideoStream, cli
from joshupscale_torch.runtime.engine import Engine, clone_state
from joshupscale_torch.runtime.native_glue import NativeEngine

REPO = Path(__file__).resolve().parent.parent
H, W, N = 16, 24, 8
SEED = 3


def _config():
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": 32, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": "float32"},
    }


@pytest.fixture(scope="module")
def make():
    return engine_factory(_config(), seed=SEED)


@pytest.fixture(scope="module")
def frames():
    return u8_frames(np.random.default_rng(11), N, H, W)


def _port_built(config, flat, seed=0):
    """The port's built inference entry holding the reference's params."""
    built = create_models(config, seed=seed)["inference"]
    built.params = from_flat_numpy(flat)
    return built


@pytest.fixture(scope="module")
def package(tmp_path_factory):
    """A package of the stream config written by the port."""
    path = tmp_path_factory.mktemp("package")
    config = _config()
    _, flat = flat_params(config, SEED)
    save_package(str(path), config, _port_built(config, flat, SEED))
    return str(path)


def _count_calls(engine, calls, side):
    process = engine.process

    def counted(frame):
        calls[side] += 1
        return process(frame)

    engine.process = counted


# The seek patterns of tests/test_video_stream.py: (max_backtrack, the
# frames requested in order, the engine calls each request makes).
SEEKS = {
    "sequential": (16, list(range(N)), [17] + [1] * (N - 1)),
    "small_backseek_from_cache": (3, [0, 1, 2, 3, 4, 4, 3, 2, 5],
                                  [4, 1, 1, 1, 1, 0, 0, 0, 1]),
    "large_backseek": (2, [0, 1, 2, 3, 4, 5, 0], [3, 1, 1, 1, 1, 1, 3]),
    "forward_jump": (2, [0, 6], [3, 3]),
    "warmup_not_cached_after_reset": (
        2, list(range(N)) + [1, 0], [3] + [1] * (N - 1) + [3, 3]),
}


@pytest.mark.parametrize("pattern", list(SEEKS))
def test_video_stream_matches_jax(make, frames, pattern):
    """Frame by frame against the JAX stream on the same source, with
    the same engine calls per request (cache hits make none; a reset
    re-warms with mirrored lead-in frames)."""
    back, requests, expected_calls = SEEKS[pattern]
    j_engine, t_engine = make()
    calls = {"jax": 0, "torch": 0}
    _count_calls(j_engine, calls, "jax")
    _count_calls(t_engine, calls, "torch")
    source = lambda i: frames[min(i, N - 1)]  # noqa: E731
    j_stream = JVideoStream(j_engine, source, num_frames=N,
                            max_backtrack=back)
    t_stream = VideoStream(t_engine, source, num_frames=N,
                           max_backtrack=back)
    made = []
    for n in requests:
        before = calls["torch"]
        ref = j_stream.get_frame(n)
        got = t_stream.get_frame(n)
        assert u8_diff(got, ref).max() <= 1, n
        assert calls["torch"] == calls["jax"], n
        made.append(calls["torch"] - before)
    assert made == expected_calls


def test_video_stream_out_of_range_raises(make, frames):
    _, t_engine = make()
    stream = VideoStream(t_engine, lambda i: frames[i], num_frames=N)
    for n in (N, -1):
        with pytest.raises(IndexError):
            stream.get_frame(n)


@pytest.mark.parametrize("max_inflight", [1, 3])
def test_process_async_matches_process_in_order(make, frames,
                                                max_inflight):
    """Each returned frame is its own, in order, and at most
    ``max_inflight`` frames stay pending; reset drains them."""
    _, engine = make(max_inflight=max_inflight)
    _, ref = make()
    outs = []
    for f in frames[:5]:
        outs.append(engine.process_async(f))
        assert len(engine._pending) <= max_inflight
    for out, f in zip(outs, frames[:5]):
        assert tuple(out.shape) == (1, 4 * H, 4 * W, 3)
        np.testing.assert_array_equal(out.numpy()[0], ref.process(f))
    engine.reset()
    assert not engine._pending


def test_benchmark_keys_errors_and_state(make, frames):
    """Both methods' keys; the reference's errors; ``scan_diff`` leaves
    the state as it found it."""
    j_engine, engine = make()
    _, ref = make()
    for f in frames[:2]:
        engine.process(f)
        ref.process(f)
    res = engine.benchmark(num_frames=8, warmup=1)
    assert set(res) == {"mean", "frame_ms", "fps", "method"}
    assert res["method"] == "scan_diff" and np.isfinite(res["frame_ms"])
    np.testing.assert_array_equal(engine.process(frames[2]),
                                  ref.process(frames[2]))
    for bad in ({"num_frames": 4}, {"method": "scan"}):
        for side in (engine, j_engine):
            with pytest.raises(ValueError):
                side.benchmark(**bad)
    res = engine.benchmark(num_frames=3, warmup=1, method="per_dispatch")
    assert set(res) == {"p50", "p99", "mean", "fps", "method"}
    assert res["method"] == "per_dispatch" and res["p50"] > 0


def test_debug_report_counts_ops_without_side_effect(make, frames):
    _, engine = make()
    _, ref = make()
    engine.process(frames[0])
    ref.process(frames[0])
    before = clone_state(engine.state)
    report = engine.debug_report()
    assert set(report) == {"instruction_counts", "num_instructions",
                           "input_shape", "output_shape"}
    assert report["input_shape"] == [1, H, W, 3]
    assert report["output_shape"] == [1, 4 * H, 4 * W, 3]
    counts = report["instruction_counts"]
    assert report["num_instructions"] == sum(counts.values())
    # On the CPU the res-block convs run their plain version: 2 flow + 2
    # generator res-block convs, plus the nets' first convs.
    assert sum(n for op, n in counts.items()
               if op.startswith("aten.conv")) >= 6
    assert all(torch.equal(a, b) for a, b in zip(
        [before["pre_gen"]] + before["last_frames"],
        [engine.state["pre_gen"]] + engine.state["last_frames"]))
    np.testing.assert_array_equal(engine.process(frames[1]),
                                  ref.process(frames[1]))


def _tier(name):
    with open(REPO / "configs" / f"inference_{name}.yaml") as f:
        config = yaml.safe_load(f)["models"]
    config["inference"] = {**config["inference"], "frame_height": H,
                           "frame_width": W, "compute_dtype": "float32"}
    return config


@pytest.mark.parametrize("tier", ["quality", "fast", "ps2_style",
                                  "ps2_fast"])
def test_save_package_round_trips_with_jax(tier, tmp_path):
    """The tier's nets, frames cut to 16x24: ``to_flat_numpy`` inverts
    ``from_flat_numpy`` (deconvs included); a package the port writes
    loads in the JAX ``load_package`` with every value as it was, and
    the JAX engine on it serves within 1 u8 step of the port's."""
    config = _tier(tier)
    _, flat = flat_params(config)
    back = to_flat_numpy(from_flat_numpy(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    built = _port_built(config, flat)
    save_package(str(tmp_path), config, built)
    model, params = j_load_package(str(tmp_path))
    loaded = flatten_params(params)
    assert set(loaded) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    frame = u8_frames(np.random.default_rng(5), 1, H, W)[0]
    got = Engine(built.obj, built.params, device="cpu").process(frame)
    assert u8_diff(got, JEngine(model, params).process(frame)).max() <= 1


def test_save_package_refuses_stablehlo(tmp_path):
    _, flat = flat_params(_config())
    with pytest.raises(NotImplementedError, match="XLA"):
        save_package(str(tmp_path / "p"), _config(),
                     _port_built(_config(), flat), export_stablehlo=True)
    assert not (tmp_path / "p").exists()


def test_native_engine_matches_jax(package, frames):
    """The bytes ABI the C++ host calls: sizes, frames within 1 step of
    the JAX glue across a reset, and its refusals."""
    j_native = JNativeEngine(package, 0)
    native = NativeEngine(package, "cpu")
    for attr in ("input_width", "input_height", "output_width",
                 "output_height"):
        assert getattr(native, attr) == getattr(j_native, attr)
    assert (native.output_height, native.output_width) == (4 * H, 4 * W)
    for i, f in enumerate(frames[:4]):
        if i == 2:
            native.reset()
            j_native.reset()
        got, ref = (np.frombuffer(e.process_bytes(f.tobytes()), np.uint8)
                    for e in (native, j_native))
        assert got.size == 4 * H * 4 * W * 3
        assert u8_diff(got, ref).max() <= 1
    with pytest.raises(ValueError, match="Expected"):
        native.process_bytes(frames[0].tobytes()[:-1])
    n = torch.cuda.device_count()
    for bad in (n, -1):
        with pytest.raises(ValueError, match=f"Invalid device {bad}; {n} "
                                             f"available"):
            NativeEngine(package, bad)


def test_cli_matches_jax(package, frames, tmp_path, capsys):
    """Both CLIs on the same PNG frames (read as BGR): output files
    within 1 step, the same report line."""
    src = tmp_path / "in"
    src.mkdir()
    for i, f in enumerate(frames[:3]):
        cv2.imwrite(str(src / f"{i:04d}.png"), f)
    assert j_cli.main([package, str(src), str(tmp_path / "jax")]) == 0
    assert cli.main([package, str(src), str(tmp_path / "torch"),
                     "--device", "cpu", "--compilation-cache"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" in ")[0] for line in lines] == [
        "processed 3 frames"] * 2
    for i in range(3):
        name = f"{i:04d}.png"
        ref = cv2.imread(str(tmp_path / "jax" / name))
        got = cv2.imread(str(tmp_path / "torch" / name))
        assert got.shape == (4 * H, 4 * W, 3)
        assert u8_diff(got, ref).max() <= 1


def test_cli_errors_match_jax(package, tmp_path, capsys):
    """No frames, or a frame that cannot be read: exit code 1 and the
    reference's message."""
    empty = tmp_path / "empty"
    empty.mkdir()
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "0000.png").write_bytes(b"not a png")
    for src in (empty, bad):
        args = [package, str(src), str(tmp_path / "out")]
        assert cli.main(args + ["--device", "cpu"]) == 1
        err = capsys.readouterr().err
        assert j_cli.main(args) == 1
        assert err and err == capsys.readouterr().err
