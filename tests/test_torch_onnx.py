"""Port parity for the ONNX door: the exporter
(``joshupscale_torch.export.onnx_export``), the codec
(``export/onnx_minimal.py``) and the graph runner
(``export/onnx_torch.py``, driven by ``export/onnx_interp.py``).

From the same params the port's ``export_onnx`` writes the JAX
exporter's file byte for byte, in every variant and tier; the port's
``run_graph`` matches the JAX one on one graph to round-off; and
``OnnxClipRunner`` on the exported graph tracks the port's CPU
``Engine`` within 1 u8 step over two streams split by a reset.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from joshupscale_tpu.export import onnx_minimal as j_om
from joshupscale_tpu.export.onnx_export import export_onnx as j_export_onnx
from joshupscale_tpu.export.onnx_interp import run_graph as j_run_graph
from joshupscale_torch.export import onnx_minimal as om
from joshupscale_torch.export.onnx_export import export_onnx
from joshupscale_torch.export.onnx_interp import OnnxClipRunner, run_graph
from joshupscale_torch.export.onnx_torch import run_graph_torch
from joshupscale_torch.export.quantize import calibrate
from joshupscale_torch.export.weights import to_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.runtime.engine import Engine

H, W = 16, 24
FILTERS = 32


def _config(flow=None, generator=None, **inference):
    return {
        "flow": flow or {"name": "flow-resnet", "num_inputs": 4,
                         "num_filters": FILTERS, "num_res_blocks": 2},
        "generator": generator or {"name": "generator-resnet",
                                   "num_filters": FILTERS,
                                   "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, **inference},
    }


def _built(config, seed):
    """The port's inference entry, BN statistics perturbed (so the folds
    are no identity) and a fade block, where there is one, mid-fade
    (counter 2 of period 8)."""
    built = create_models(config, seed=seed)["inference"]
    rng = np.random.default_rng(seed + 100)

    def perturb(tree, path=""):
        for k, v in tree.items():
            p = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                perturb(v, p)
            elif k == "moving_mean":
                tree[k] = torch.from_numpy(
                    (rng.standard_normal(v.shape) * 0.1).astype(np.float32))
            elif k == "moving_variance":
                tree[k] = torch.from_numpy(
                    (1 + rng.random(v.shape)).astype(np.float32))
            elif k == "counter":
                tree[k] = torch.tensor(2.0)

    perturb(built.params)
    return built


def _reference_tree(params):
    """The same params as the JAX package holds them (jnp leaves, the
    reference's layouts)."""
    tree = {}
    for path, arr in to_flat_numpy(params).items():
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(arr)
    return tree


def _options(m):
    return dict(num_flow_frames=m.num_flow_frames,
                frame_moving_avg=m.frame_moving_avg,
                output_flow=m.output_flow, remove_flow=m.remove_flow,
                flow_pad_factor=m.flow_pad_factor,
                normalize_brightness=m.normalize_brightness)


_AUTOENCODER = {"name": "flow-autoencoder", "num_inputs": 4,
                "filters": [FILTERS, 2 * FILTERS, FILTERS]}
_FADE_GENERATOR = {"name": "generator-resnet", "num_filters": FILTERS,
                   "num_res_blocks": 1, "num_fade_in_res_blocks": 1,
                   "fade_in_period": 8}
_VARIANTS = {
    "float": (_config(), {}),
    "fp16": (_config(), {"fp16": True}),
    "int8_qdq": (_config(), {"int8": True}),
    "moving_avg_global": (_config(frame_moving_avg={
        "strength": 0.25, "threshold": 0.1}), {}),
    "moving_avg_windowed": (_config(frame_moving_avg={
        "strength": 0.7, "window": 24, "threshold": 0.02, "gain": 8.0,
        "norm": "l2", "luma_normalize": True, "limit": True}), {}),
    "output_flow": (_config(output_flow=True), {}),
    "remove_flow": (_config(remove_flow=True), {}),
    "autoencoder_pad_brightness": (_config(
        flow=_AUTOENCODER, flow_pad_factor=16, normalize_brightness=True),
        {}),
    "fade_in": (_config(generator=_FADE_GENERATOR), {}),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_export_is_reference_file_byte_for_byte(variant, tmp_path):
    """The same params through both exporters, with the model's options
    (and the int8 tier's ranges from the port's ``calibrate``, one dict
    fed to both): the same file, byte for byte."""
    config, tier = _VARIANTS[variant]
    built = _built(config, seed=len(variant))
    m = built.obj
    opts = _options(m)
    if tier.get("int8"):
        frames = np.random.default_rng(1).integers(
            0, 256, (3, 1, H, W, 3), np.uint8)
        tier = {"int8_ranges": calibrate(m, built.params, frames,
                                         device="cpu")}
    ours, theirs = str(tmp_path / "port.onnx"), str(tmp_path / "ref.onnx")
    export_onnx(ours, built.params, H, W, **tier, **opts)
    j_export_onnx(theirs, _reference_tree(built.params), H, W, **tier,
                  **opts)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    model = om.decode_model(data)
    assert model["producer"] == "joshupscale_tpu" and model["opset"] == 16
    ops = [n["op_type"] for n in model["nodes"]]
    if "int8_ranges" in tier:
        assert ops.count("QuantizeLinear") == 2 * len(tier["int8_ranges"])
    if variant == "fade_in":
        assert model["initializers"][
            "generator.block_2.fade_scale"].item() == 0.25
    if variant == "autoencoder_pad_brightness":
        assert ops.count("Pad") == ops.count("MaxPool") == 1
        shapes = {v["name"]: v["shape"] for v in model["inputs"]}
        assert shapes["last_frame_0"] == [1, 3, 16, 32]


def test_contradictory_options_raise(tmp_path):
    params = _built(_config(), seed=0).params
    path = str(tmp_path / "x.onnx")
    for kw in ({"output_flow": True, "remove_flow": True},
               {"output_flow": True, "frame_moving_avg": {"strength": 0.5}},
               {"remove_flow": True, "frame_moving_avg": {"strength": 0.5}},
               {"fp16": True, "int8_ranges": {"flow.conv_1": 1.0}}):
        with pytest.raises(ValueError):
            export_onnx(path, params, H, W, **kw)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """The float graph of the base config, and its built model."""
    built = _built(_config(), seed=3)
    path = str(tmp_path_factory.mktemp("onnx") / "model.onnx")
    export_onnx(path, built.params, H, W)
    return built, path


def test_runners_match_reference_run_graph(graph):
    """One frame through the exported graph with random states: the
    port's ``run_graph`` (torch ops on the CPU) against the JAX
    ``run_graph`` (numpy, convs through XLA), to float32 round-off; the
    fp16 island (f32 coordinate math fenced by Casts in an fp16 graph)
    kept."""
    _, path = graph
    data = open(path, "rb").read()
    ours, theirs = om.decode_model(data), j_om.decode_model(data)
    rng = np.random.default_rng(8)
    feeds = {"cur_frame": rng.integers(0, 256, (1, H, W, 3)).astype(
        np.float32),
        "pre_gen": rng.uniform(-0.5, 0.5, (1, 3, 4 * H, 4 * W)).astype(
            np.float32),
        **{f"last_frame_{i}": rng.uniform(-0.5, 0.5, (1, 3, H, W)).astype(
            np.float32) for i in range(3)}}
    want = j_run_graph(theirs, feeds)
    got = run_graph(ours, feeds)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        # "output" is on the [0, 255] scale, the rest on [-0.5, 0.5].
        tol = 2e-3 if k == "output" else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)

    def n(op, inputs, out, **attrs):
        return {"op_type": op, "inputs": inputs, "outputs": [out],
                "attrs": attrs}

    island = {
        "initializers": {"w16": np.asarray([1.0], np.float16),
                         "base": np.asarray([1919.0], np.float32),
                         "base2": np.asarray([1918.0], np.float32)},
        "inputs": [{"name": "flow", "shape": [1]}],
        "nodes": [n("Cast", ["flow"], "flow32", to=om.FLOAT),
                  n("Sub", ["base", "flow32"], "q"),
                  n("Sub", ["q", "base2"], "frac"),
                  n("Cast", ["frac"], "out", to=om.FLOAT16),
                  n("Mul", ["flow", "w16"], "out_f16")],
        "outputs": [{"name": "out"}, {"name": "out_f16"}],
    }
    flow = np.asarray([0.372], np.float16)
    # Squashed to f16, q would be 1919.0 and the fraction 1.0.
    want = np.float16(1919.0 - float(flow[0]) - 1918.0)
    r = run_graph(island, {"flow": flow})
    np.testing.assert_allclose(np.asarray(r["out"], np.float32), want,
                               rtol=1e-3)
    assert r["out_f16"].dtype == np.float16


def test_clip_runner_tracks_engine(graph):
    """``OnnxClipRunner`` over the exported graph on the CPU (executor
    ``run_graph``) against the port's ``Engine`` on the CPU from the same
    params (float 32, the s2d step): at most 1 u8 step apart on every
    frame of two streams split by a ``reset()``.  With no executor the
    runner is on the card: without one it raises."""
    built, path = graph
    engine = Engine(built.obj, built.params, device="cpu")
    runner = OnnxClipRunner(path, H, W, executor=run_graph)
    rng = np.random.default_rng(9)
    for stream in range(2):
        engine.reset()
        runner.reset()
        base = rng.integers(0, 256, (H, W, 3), np.uint8)
        for t in range(3):
            frame = np.roll(base, t, axis=1)
            ours = engine.process(frame).astype(np.int32)
            d = np.abs(runner.process(frame).astype(np.int32) - ours).max()
            assert d <= 1, (stream, t, d)
    default = OnnxClipRunner(path, H, W)
    assert default._run is run_graph_torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default.process(frame)
