"""Port parity for the PS2 flow-autoencoder family vs the JAX package.

The ops it adds (brightness, the wide bilinear upscale, the general
resize), the autoencoder flow net, and the PS2 serving configuration
(autoencoder + generator, ``flow_pad_factor: 8``,
``normalize_brightness``) through both engines at a small size: 21x30
LR frames, padded unevenly to 24x32.  The tier configs under
``configs/`` are built as files.  Params are carried across with
``flatten_params`` -> ``from_flat_numpy``; inputs come from numpy.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from _torch_parity import engines, flat_params, sub_params, u8_diff, u8_frames
from joshupscale_tpu.export.importer import flatten_params, unflatten_into
from joshupscale_tpu.export.package import save_package
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.models import fnet as jfnet
from joshupscale_tpu.ops import image as jimage
from joshupscale_tpu.ops import resize as jresize
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models import fnet as tfnet
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.ops import image as timage
from joshupscale_torch.ops import resize as tresize
from joshupscale_torch.runtime.engine import create_runtime

REPO = Path(__file__).resolve().parent.parent
H, W = 21, 30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _config(compute_dtype="float32", filters=(8, 16, 32, 64, 32, 16, 8),
            **inference):
    return {
        "flow": {"name": "flow-autoencoder", "num_inputs": 4,
                 "filters": list(filters)},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": compute_dtype,
                      "flow_pad_factor": 8, "normalize_brightness": True,
                      **inference},
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_brightness_matches_jax(rng, dtype):
    """f32 within 1e-5 (the f32 sum runs in another order); bf16 within
    one bf16 ulp at 0.5 (the same products, the f32 mean rounded once)."""
    x = rng.random((3, 9, 14, 3), np.float32) - 0.5
    ref = np.asarray(jimage.brightness(jnp.asarray(x, getattr(jnp, dtype))),
                     np.float32)
    got = timage.brightness(_t(x).to(getattr(torch, dtype)))
    assert got.shape == (3, 1, 1, 1) and got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -9
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)
    assert timage.brightness(_t(x), keepdims=False).shape == (3,)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upscale_bilinear_wide_broadcast(rng, scale):
    """The broadcast branch (more than 8 channels), f32 within 1e-5: the
    same four products summed in the same order."""
    x = rng.random((2, 5, 7, 24), np.float32) - 0.5
    ref = np.asarray(jresize.upscale_bilinear(jnp.asarray(x), scale))
    got = tresize.upscale_bilinear(_t(x), scale)
    assert got.shape == (2, 5 * scale, 7 * scale, 24)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw,c", [
    ((4, 6), (16, 24), 1),    # integer, same factor: the conv path
    ((4, 6), (8, 12), 16),    # integer, same factor: the broadcast path
    ((5, 7), (12, 9), 3),     # non-integer both ways, one axis shrinks
    ((4, 6), (8, 18), 2),     # integer factors that differ per axis
])
def test_resize_bilinear(rng, in_hw, out_hw, c):
    """f32 within 1e-5: the legacy TF1 grid, integer and non-integer
    sizes."""
    x = rng.random((2,) + in_hw + (c,), np.float32) - 0.5
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *out_hw))
    got = tresize.resize_bilinear(_t(x), *out_hw)
    assert got.shape == (2,) + out_hw + (c,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("filters", [(8, 16, 32, 64, 32, 16, 8),
                                     (8, 16, 16, 8)],
                         ids=["odd-mid-conv", "even"])
@pytest.mark.parametrize("s2d_output", [True, False])
def test_flow_autoencoder_matches_jax(rng, filters, s2d_output):
    """f32 within 1e-4: the ladder's convs, batch norms (not folded, as
    the reference), max pools, x2 upscales and the head, with sums in
    another order.  An odd filter list adds the mid ``conv_1``."""
    config = _config(filters=filters)
    _, flat = flat_params(config)
    jp = sub_params(flat, "flow", j_create_models(config)["flow"].params)
    tp = tfnet.prepare_flow_autoencoder(from_flat_numpy(flat)["flow"],
                                        torch.float32)
    assert ("conv_1" in tp) == (len(filters) % 2 == 1)
    frames = [rng.random((2, 16, 24, 3), np.float32) - 0.5
              for _ in range(4)]
    ref = np.asarray(jfnet.flow_autoencoder_apply(
        jp, [jnp.asarray(f) for f in frames], s2d_output=s2d_output))
    got = tfnet.flow_autoencoder_apply(tp, [_t(f) for f in frames],
                                       s2d_output=s2d_output)
    assert got.shape == ((2, 16, 24, 32) if s2d_output else (2, 64, 96, 2))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_ps2_engine_matches_jax_f32_recurrent(rng):
    """12 recurrent frames, padded 21x30 -> 24x32 (1 row on top, 2 at
    the bottom; 1 column each side), brightness on: u8 within 1 step."""
    j_engine, t_engine = engines(_config())
    model = t_engine.model
    assert (model.padded_height, model.padded_width) == (24, 32)
    assert t_engine.state["last_frames"][0].shape == (1, 24, 32, 3)
    for frame in u8_frames(rng, 12, H, W):
        assert u8_diff(t_engine.process(frame),
                       j_engine.process(frame)).max() <= 1


def test_ps2_last_frames_hold_the_padded_normalized_frame(rng):
    """The shift register takes the frame minus its brightness, zero
    padded (the ring stays exactly zero), as the reference's does."""
    _, t_engine = engines(_config())
    frame = u8_frames(rng, 1, H, W)[0]
    t_engine.process(frame)
    newest = t_engine.state["last_frames"][0][0]
    pre = timage.preprocess(_t(frame))
    inner = pre - timage.brightness(pre[None])[0]
    torch.testing.assert_close(newest[1:1 + H, 1:1 + W], inner,
                               rtol=0, atol=0)
    ring = newest.clone()
    ring[1:1 + H, 1:1 + W] = 0
    assert float(ring.abs().max()) == 0.0


def test_ps2_engine_matches_jax_bf16(rng):
    """bf16 compute, 3 frames: u8 within 2 steps and at most 10% of the
    values differing (bf16 rounds at other places in the two packages,
    as in the quality tier's test)."""
    j_engine, t_engine = engines(_config("bfloat16"))
    for frame in u8_frames(rng, 3, H, W):
        diff = u8_diff(t_engine.process(frame), j_engine.process(frame))
        assert diff.max() <= 2
        assert (diff > 0).mean() <= 0.10


def _tier(name):
    with open(REPO / "configs" / f"inference_{name}.yaml") as f:
        return yaml.safe_load(f)["models"]


def _shapes(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}.{k}" if path else k
        if isinstance(v, dict):
            out.update(_shapes(v, p))
        else:
            out[p] = tuple(v.shape)
    return out


@pytest.mark.parametrize("tier", ["quality", "fast", "ps2_style",
                                  "ps2_fast"])
def test_tier_config_builds_with_reference_shapes(tier):
    """Every tier config file builds on the port with the reference's
    parameters, each of the same size (the port's kernels are stored
    OHWI, its deconvs as (I, 4*O) products)."""
    config = _tier(tier)
    built = create_models(config)["inference"]
    ref = j_create_models(config)["inference"]
    ref_shapes = {k: v.shape for k, v in flatten_params(ref.params).items()}
    got = _shapes(built.params)
    assert set(got) == set(ref_shapes)
    for k, shape in got.items():
        assert int(np.prod(shape)) == int(np.prod(ref_shapes[k])), k
    assert built.obj.frame_height == 270 and built.obj.frame_width == 480


@pytest.mark.parametrize("tier", ["ps2_style", "ps2_fast"])
def test_ps2_tier_one_frame_matches_jax(rng, tier):
    """The tier's own nets at frame size (24, 32), f32: one frame
    through both engines within 1 u8 step."""
    config = _tier(tier)
    config["inference"] = {**config["inference"], "frame_height": 24,
                           "frame_width": 32, "compute_dtype": "float32"}
    j_engine, t_engine = engines(config)
    frame = u8_frames(rng, 1, 24, 32)[0]
    assert u8_diff(t_engine.process(frame),
                   j_engine.process(frame)).max() <= 1


def test_ps2_package_serves_as_the_reference(rng, tmp_path):
    """A PS2 package written by the reference's save_package (model.yaml
    with the autoencoder's filter list, params.npz) loads on the port
    and serves the frames of the port engine built from the carried
    params, exactly."""
    config = _config()
    built, flat = flat_params(config)
    built.params = unflatten_into(built.params, flat)
    save_package(str(tmp_path), config, built)
    loaded = create_runtime(str(tmp_path), device="cpu")
    assert loaded.model.flow_pad_factor == 8
    _, t_engine = engines(config)
    for frame in u8_frames(rng, 3, H, W):
        np.testing.assert_array_equal(loaded.process(frame),
                                      t_engine.process(frame))
