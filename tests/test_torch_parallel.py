"""Port parity for multi-stream and pipelined serving vs the JAX package.

``ShardedEngine`` on two CPU "devices" x 2 streams against the JAX
``ShardedEngine`` on a 2-device CPU mesh (``tests/conftest.py`` provides
8 host devices) and against single-stream port engines;
``PipelinedEngine`` against the port's ``Engine`` (stream, clip, async,
reset) and the JAX ``PipelinedEngine``.  Small nets at 8x12 LR frames;
params carried across with ``flatten_params`` -> ``from_flat_numpy``.
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import flat_params, u8_diff
from joshupscale_tpu.export.importer import unflatten_into
from joshupscale_tpu.parallel import PipelinedEngine as JPipelinedEngine
from joshupscale_tpu.parallel import ShardedEngine as JShardedEngine
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.parallel import PipelinedEngine, ShardedEngine
from joshupscale_torch.runtime.engine import Engine

H, W = 8, 12


def _config(**inference):
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, **inference},
    }


def _both(config):
    """(reference model, its params, port model, its params): the same
    weights on both sides."""
    built, flat = flat_params(config, seed=5)
    t_model = create_models(config, seed=5)["inference"].obj
    return (built.obj, unflatten_into(built.params, flat), t_model,
            from_flat_numpy(flat))


def test_sharded_engine_matches_reference_and_single_engines(rng):
    """2 CPU devices x 2 streams: the batch of 4 equals 4 single-stream
    port engines bit for bit (each device's engine runs the same step
    on its 2 streams), and the JAX ``ShardedEngine`` on a 2-device mesh
    within 1 u8 step (f32; float sums in another order, as the engines'
    parity tests); ``reset`` restarts every stream."""
    j_model, j_params, t_model, t_params = _both(_config())
    sharded = ShardedEngine(t_model, t_params, devices=["cpu", "cpu"],
                            streams_per_device=2)
    assert sharded.batch_size == 4 and len(sharded.engines) == 2
    assert sharded.input_shape == (4, H, W, 3)
    ref = JShardedEngine(j_model, j_params,
                         mesh=Mesh(np.asarray(jax.devices()[:2]),
                                   ("stream",)), streams_per_device=2)
    frames = rng.integers(0, 256, (3, 4, H, W, 3)).astype(np.uint8)
    outs = [sharded.process(f) for f in frames]
    for t, f in enumerate(frames):
        assert outs[t].shape == (4, 4 * H, 4 * W, 3)
        assert u8_diff(outs[t], ref.process(f)).max() <= 1
    for s in range(4):
        single = Engine(t_model, t_params, device="cpu")
        for t in range(3):
            np.testing.assert_array_equal(outs[t][s],
                                          single.process(frames[t, s]))
    sharded.reset()
    np.testing.assert_array_equal(sharded.process(frames[0]), outs[0])
    with pytest.raises(ValueError):
        sharded.process(frames[0, :3])


def test_sharded_engine_needs_a_card_by_default():
    """Without ``devices`` the engine takes every CUDA device and raises
    where there is none; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, t_model, t_params = _both(_config())
    with pytest.raises(RuntimeError):
        ShardedEngine(t_model, t_params)
    with pytest.raises(RuntimeError):
        PipelinedEngine(t_model, t_params)


_PIPE_VARIANTS = {"s2d": {}, "pixel": {"s2d_mode": False},
                  "brightness": {"normalize_brightness": True},
                  "u8_state": {"u8_state": True}}


@pytest.mark.parametrize("variant", sorted(_PIPE_VARIANTS))
def test_pipelined_engine_matches_engine(rng, variant):
    """Flow stage on one CPU device, generator stage on the other: the
    stream, ``process_clip`` after a ``reset`` and ``process_async``
    equal the single-device ``Engine`` bit for bit (the same stages in
    the same order); each stage's state lives on its device."""
    _, _, t_model, t_params = _both(_config(**_PIPE_VARIANTS[variant]))
    single = Engine(t_model, t_params, device="cpu")
    piped = PipelinedEngine(t_model, t_params, devices=["cpu", "cpu"])
    assert set(piped.flow_state) == {"last_frames"}
    assert set(piped.gen_state) == {"pre_gen"}
    frames = rng.integers(0, 256, (5, H, W, 3)).astype(np.uint8)
    want = np.stack([single.process(f) for f in frames])
    got = np.stack([piped.process(f) for f in frames])
    np.testing.assert_array_equal(got, want)
    piped.reset()
    np.testing.assert_array_equal(piped.process_clip(frames), want)
    piped.reset()
    outs = [piped.process_async(f) for f in frames]
    np.testing.assert_array_equal(
        np.stack([o.numpy()[0] for o in outs]), want)
    piped.reset()
    np.testing.assert_array_equal(
        piped.process_clip(frames[:, None])[:, 0], want)


def test_pipelined_engine_matches_reference(rng):
    """The port's pipeline against the JAX ``PipelinedEngine`` on two
    CPU devices: within 1 u8 step (f32, as the engines' parity tests);
    stream and clip."""
    j_model, j_params, t_model, t_params = _both(_config())
    ref = JPipelinedEngine(j_model, j_params, devices=jax.devices()[:2])
    piped = PipelinedEngine(t_model, t_params, devices=["cpu", "cpu"])
    frames = rng.integers(0, 256, (4, H, W, 3)).astype(np.uint8)
    for f in frames:
        assert u8_diff(piped.process(f), ref.process(f)).max() <= 1
    piped.reset()
    ref.reset()
    assert u8_diff(piped.process_clip(frames),
                   ref.process_clip(frames)).max() <= 1


def test_pipelined_engine_raises_as_reference():
    """``remove_flow`` has no flow stage to pipeline, and the engine
    takes exactly two devices; a wrong frame shape raises."""
    _, _, t_model, t_params = _both(_config())
    for devices in (["cpu"], ["cpu", "cpu", "cpu"]):
        with pytest.raises(ValueError):
            PipelinedEngine(t_model, t_params, devices=devices)
    piped = PipelinedEngine(t_model, t_params, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        piped.process(np.zeros((4, 4, 3), np.uint8))
    config = _config(remove_flow=True)
    del config["flow"], config["inference"]["flow"]
    built = create_models(config)["inference"]
    with pytest.raises(ValueError):
        PipelinedEngine(built.obj, built.params, devices=["cpu", "cpu"])
