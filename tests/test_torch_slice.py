"""Port parity for the whole serving slice: nets, engine, package load.

The quality tier's architecture (flow-resnet + generator-resnet, s2d
mode, deferred display) at a small size: 16x24 LR frames, 32-filter
nets of 2 res blocks.  JAX params are carried over with
``flatten_params`` -> ``from_flat_numpy``; inputs come from numpy.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import engines, flat_params
from joshupscale_tpu.export.importer import unflatten_into
from joshupscale_tpu.export.package import save_package
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.models.fnet import flow_resnet_apply as j_flow
from joshupscale_tpu.models.generator import (
    generator_resnet_apply as j_generator,
)
from joshupscale_tpu.runtime.engine import Engine as JEngine
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models.fnet import (
    flow_resnet_apply as t_flow,
    prepare_flow_resnet,
)
from joshupscale_torch.models.generator import (
    generator_resnet_apply as t_generator,
    prepare_generator_resnet,
)
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.runtime.engine import Engine, create_runtime

REPO = Path(__file__).resolve().parent.parent
H, W = 16, 24


def _config(compute_dtype="float32", **inference):
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": 32, "num_res_blocks": 2},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": compute_dtype,
                      **inference},
    }


def _frames(rng, t):
    return rng.integers(0, 256, (t, H, W, 3)).astype(np.uint8)


def test_flow_resnet_s2d_matches_jax(rng):
    """f32 within 1e-4: 2 res blocks + head; sums in another order."""
    _, flat = flat_params(_config())
    jp = {k[len("flow."):]: jnp.asarray(v) for k, v in flat.items()
          if k.startswith("flow.")}
    tp = prepare_flow_resnet(from_flat_numpy(flat)["flow"], torch.float32)
    frames = [rng.random((2, H, W, 3), np.float32) - 0.5 for _ in range(4)]
    jparams = unflatten_into(
        j_create_models(_config())["flow"].params, jp)
    ref = np.asarray(j_flow(jparams, [jnp.asarray(f) for f in frames],
                            s2d_output=True))
    got = t_flow(tp, [torch.from_numpy(f) for f in frames], s2d_output=True)
    assert got.shape == (2, H, W, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_generator_s2d_tail_matches_jax(rng):
    """f32 within 1e-4: conv, 2 res blocks and the s2d tail."""
    _, flat = flat_params(_config())
    jp = {k[len("generator."):]: jnp.asarray(v) for k, v in flat.items()
          if k.startswith("generator.")}
    jparams = unflatten_into(
        j_create_models(_config())["generator"].params, jp)
    tp = prepare_generator_resnet(from_flat_numpy(flat)["generator"],
                                  torch.float32)
    frame = rng.random((2, H, W, 3), np.float32) - 0.5
    pre_warp = rng.random((2, H, W, 48), np.float32) - 0.5
    ref = np.asarray(j_generator(jparams, jnp.asarray(frame),
                                 jnp.asarray(pre_warp), s2d_output=True))
    got = t_generator(tp, torch.from_numpy(frame),
                      torch.from_numpy(pre_warp), s2d_output=True)
    assert got.shape == (2, H, W, 48)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_engine_matches_jax_f32_recurrent(rng):
    """12 recurrent frames: u8 within 1 step (f32 round-off can tip a
    truncating cast by one)."""
    j_engine, t_engine = engines(_config())
    assert t_engine._deferred
    for frame in _frames(rng, 12):
        ref = j_engine.process(frame)
        got = t_engine.process(frame)
        assert got.shape == (4 * H, 4 * W, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1


def test_engine_matches_jax_bf16(rng):
    """bf16 compute, 3 frames: u8 within 2 steps and at most 10% of the
    values differing.  bf16 keeps 8 bits, about one u8 step at 0.5, and
    the port rounds the res-block epilogue once in f32 where the
    reference rounds the conv and the BN apart."""
    j_engine, t_engine = engines(_config("bfloat16"))
    for frame in _frames(rng, 3):
        ref = j_engine.process(frame).astype(np.int32)
        got = t_engine.process(frame).astype(np.int32)
        diff = np.abs(got - ref)
        assert diff.max() <= 2
        assert (diff > 0).mean() <= 0.10


def test_step_builds_no_host_constants(rng, monkeypatch):
    """Every fold, cast and constant table of the step (the tail's
    block-diagonal product, the bilinear phase kernel) is made when the
    engine is built: on a card a tensor made from host data inside the
    step would stall it on the copy."""
    _, t_engine = engines(_config("bfloat16"))
    frame = torch.from_numpy(_frames(rng, 1))

    def refuse(*args, **kwargs):
        raise AssertionError("the step made a tensor from host data")

    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse)
    out = t_engine.step(frame)
    assert out.shape == (1, H, W, 48) and out.dtype == torch.bfloat16


def test_process_clip_equals_streaming_and_reset(rng):
    _, t_engine = engines(_config())
    frames = _frames(rng, 5)
    streamed = np.stack([t_engine.process(f) for f in frames])
    t_engine.reset()
    assert float(t_engine.state["pre_gen"].abs().max()) == 0.0
    assert all(float(b.abs().max()) == 0.0
               for b in t_engine.state["last_frames"])
    np.testing.assert_array_equal(t_engine.process_clip(frames), streamed)
    t_engine.reset()
    chunked = t_engine.process_clip(frames[:, None], chunk_frames=2)
    assert chunked.shape == (5, 1, 4 * H, 4 * W, 3)
    np.testing.assert_array_equal(chunked[:, 0], streamed)
    assert t_engine.frames_processed == 5
    assert t_engine.avg_frame_seconds > 0


def test_inline_display_equals_deferred(rng):
    _, flat = flat_params(_config())
    params = from_flat_numpy(flat)
    frames = _frames(rng, 3)
    outs = []
    for deferred in (True, False):
        built = create_models(_config(deferred_display=deferred))
        engine = Engine(built["inference"].obj, params, device="cpu")
        assert engine._deferred == deferred
        outs.append(engine.process_clip(frames))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_package_roundtrip_serves_same_frames(rng, tmp_path):
    """JAX save_package -> port create_runtime serves the same frames as
    the port engine built from the carried params (exact) and the JAX
    engine (within 1 step)."""
    config = _config()
    built, flat = flat_params(config)
    built.params = unflatten_into(built.params, flat)
    save_package(str(tmp_path), config, built)
    loaded = create_runtime(str(tmp_path), device="cpu")
    _, t_engine = engines(config)
    j_engine = JEngine(built.obj, built.params)
    for frame in _frames(rng, 3):
        got = loaded.process(frame)
        np.testing.assert_array_equal(got, t_engine.process(frame))
        assert np.abs(got.astype(np.int32)
                      - j_engine.process(frame).astype(np.int32)).max() <= 1
    resized = create_runtime(str(tmp_path), device="cpu",
                             frame_size=(8, 12))
    assert resized.output_shape == (1, 32, 48, 3)
    assert resized.process(_frames(rng, 1)[0][:8, :12]).shape == (32, 48, 3)


def test_bad_inputs_and_no_cuda_raise(rng, monkeypatch):
    _, t_engine = engines(_config())
    with pytest.raises(ValueError):
        t_engine.process(np.zeros((H + 1, W, 3), np.uint8))
    with pytest.raises(ValueError):
        t_engine.process_clip(np.zeros((2, H, W + 4, 3), np.uint8))
    built = create_models(_config())["inference"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(built.obj, built.params)


def test_init_state_runs_on_the_card_unless_asked(monkeypatch):
    """Like every entry point, the zero state goes to the CUDA device
    unless the caller names the CPU."""
    model = create_models(_config())["inference"].obj
    state = model.init_state(2, device="cpu")
    assert state["pre_gen"].shape == (2, H, W, 48)
    assert all(t.device.type == "cpu" for t in state["last_frames"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_state(1)


@pytest.mark.parametrize("option", [
    {"s2d_mode": False}, {"remove_flow": True}, {"u8_state": True},
    {"output_flow": True}, {"normalize_brightness": True},
    {"flow_pad_factor": 8},
    {"frame_moving_avg": {"strength": 0.7, "threshold": 0.1}},
])
def test_serving_option_matches_jax(rng, option):
    """Each serving option of the reference's inference model builds on
    the port and serves 2 recurrent frames within 1 u8 step of it (f32;
    the options' own parity tests run longer in test_torch_variants.py
    and test_torch_ps2.py)."""
    j_engine, t_engine = engines(_config(**option))
    for frame in _frames(rng, 2):
        ref = j_engine.process(frame).astype(np.int32)
        got = t_engine.process(frame).astype(np.int32)
        assert np.abs(got - ref).max() <= 1


def test_unported_model_types_raise():
    """Every factory of the reference is ported (the GAN slice's
    ``discriminator`` builds); a type the registry does not know is
    refused by name, as the reference refuses it."""
    assert create_models({"d": {"name": "discriminator", "alpha": 0.25}})[
        "d"].kind == "discriminator"
    config = _config()
    config["flow"] = {"name": "no-such-model"}
    with pytest.raises(ValueError, match="no-such-model"):
        create_models(config)


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax, tensorflow nor the
    JAX package; yaml only in the package files and the training CLI;
    h5py, cv2 and PIL only where a call needs them (none at import)."""
    code = ("import sys, joshupscale_torch, joshupscale_torch.runtime.engine,"
            " joshupscale_torch.export.package, joshupscale_torch.kernels."
            "resblock, joshupscale_torch.kernels.display,"
            " joshupscale_torch.kernels.probes,"
            " joshupscale_torch.tools.conv_probe,"
            " joshupscale_torch.runtime.stream, joshupscale_torch.runtime.cli,"
            " joshupscale_torch.runtime.native_glue,"
            " joshupscale_torch.export.quantize, joshupscale_torch.parallel,"
            " joshupscale_torch.training, joshupscale_torch.training.cli,"
            " joshupscale_torch.training.gan, joshupscale_torch.training.play,"
            " joshupscale_torch.models.discriminator,"
            " joshupscale_torch.models.vgg, joshupscale_torch.utils.migrate,"
            " joshupscale_torch.data, joshupscale_torch.data.tfrecord,"
            " joshupscale_torch.data.mploader,"
            " joshupscale_torch.export.onnx_minimal,"
            " joshupscale_torch.export.onnx_export,"
            " joshupscale_torch.export.onnx_interp,"
            " joshupscale_torch.export.onnx_torch,"
            " joshupscale_torch.export.importer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'joshupscale_tpu', 'yaml', 'tensorflow',"
            " 'h5py', 'cv2', 'PIL')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    sources = sorted((REPO / "joshupscale_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                continue
            top = words[1].split(".")[0]
            assert top not in ("jax", "jaxlib", "joshupscale_tpu",
                               "tensorflow"), (path, line)
            if top == "yaml":
                assert (path.name == "package.py" or path.parts[-2:]
                        == ("training", "cli.py")), (path, line)
