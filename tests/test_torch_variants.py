"""Port parity for the inference model's serving options vs the JAX
package: ``u8_state``, ``frame_moving_avg`` (global and windowed),
``output_flow``, ``remove_flow`` and pixel mode (``s2d_mode=False``),
with the ops they add (the pixel warp, the u8-table warp, the kernel-2
deconv, the moving average) and the generator's non-temporal and pixel
forms.  Small sizes; params carried across with ``flatten_params`` ->
``from_flat_numpy``; inputs from numpy.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import engines, flat_params, sub_params, u8_diff, u8_frames
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.models import generator as jgen
from joshupscale_tpu.models.inference import InferenceModel as JModel
from joshupscale_tpu.nn import layers as jlayers
from joshupscale_tpu.ops import temporal as jtemporal
from joshupscale_tpu.ops import warp as jwarp
from joshupscale_tpu.ops.space_depth import space_to_depth
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models import generator as tgen
from joshupscale_torch.models.generator import deconv_matrix
from joshupscale_torch.models.inference import InferenceModel
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.nn import layers as tlayers
from joshupscale_torch.ops import temporal as ttemporal
from joshupscale_torch.ops import warp as twarp
from joshupscale_torch.runtime.engine import Engine

H, W = 16, 24
MA = {"strength": 0.7, "threshold": 0.1}


def _t(a):
    return torch.from_numpy(np.array(a))


def _config(**inference):
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": 32, "num_res_blocks": 2},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": "float32",
                      **inference},
    }


def _no_flow_config():
    config = _config(remove_flow=True)
    del config["flow"], config["inference"]["flow"]
    return config


# ---- ops --------------------------------------------------------------


@pytest.mark.parametrize("n,reach", [(1, 0.2), (2, 1.5)])
def test_dense_image_warp_pixel_matches_jax(rng, n, reach):
    """f32 within 1e-5: the same f32 index math and blend; at reach 1.5
    the flows run off every edge."""
    image = rng.random((n, 12, 20, 3), np.float32) - 0.5
    flow = ((rng.random((n, 12, 20, 2), np.float32) * 2 - 1)
            * np.array([12, 20], np.float32) * reach).astype(np.float32)
    ref = np.asarray(jwarp.dense_image_warp(jnp.asarray(image),
                                            jnp.asarray(flow)))
    got = twarp.dense_image_warp(_t(image), _t(flow))
    assert got.dtype == torch.float32 and got.shape == image.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_warp_u8_table_dequantizes(rng):
    """The u8 table's warp equals the float warp of the dequantized
    image within bf16 rounding: a bf16 combine of raw 0..255 values (an
    ulp of 1 above 128, i.e. 0.004 after /255) over up to 25 terms,
    then one f32 affine; bound 0.02."""
    img_u8 = rng.integers(0, 256, (2, 4, 6, 48)).astype(np.uint8)
    flow = (rng.random((2, 4, 6, 32), np.float32) * 2 - 1) * 8
    got = twarp.dense_image_warp_s2d(_t(img_u8), _t(flow))
    assert got.dtype == torch.bfloat16 and got.shape == img_u8.shape
    ref = twarp.dense_image_warp_s2d(
        _t(img_u8.astype(np.float32) / 255.0 - 0.5), _t(flow))
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=0.02,
                               rtol=0)


@pytest.mark.parametrize("bias", [False, True])
def test_conv2d_transpose_2x_matches_jax(rng, bias):
    """f32 within 1e-5: the port's (I, 4*O) product, d2s(2), bias."""
    k = rng.standard_normal((2, 2, 5, 12)).astype(np.float32) * 0.3
    b = rng.standard_normal(5).astype(np.float32)
    x = rng.standard_normal((2, 6, 7, 12)).astype(np.float32)
    jp, tp = {"kernel": jnp.asarray(k)}, {"kernel": _t(deconv_matrix(k))}
    if bias:
        jp["bias"], tp["bias"] = jnp.asarray(b), _t(b)
    ref = np.asarray(jlayers.conv2d_transpose_2x(jp, jnp.asarray(x)))
    got = tlayers.conv2d_transpose_2x(tp, _t(x))
    assert got.shape == (2, 12, 14, 5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("frame_only,s2d_output", [
    (True, False),   # remove_flow: frame alone, pixel tail
    (False, False),  # pixel mode
    (True, True),    # frame alone, s2d tail
])
def test_generator_forms_match_jax(rng, frame_only, s2d_output):
    """f32 within 1e-4: conv_1 cut to the frame's 3 channels where there
    is no pre_warp, and the pixel tail (deconv-BN-act-deconv-tanh +
    bilinear x4 skip, clip)."""
    config = _config()
    _, flat = flat_params(config)
    jp = sub_params(flat, "generator",
                    j_create_models(config)["generator"].params)
    tp = tgen.prepare_generator_resnet(
        from_flat_numpy(flat)["generator"], torch.float32,
        s2d_output=s2d_output, frame_only=frame_only)
    frame = rng.random((2, H, W, 3), np.float32) - 0.5
    pre_warp = None
    if not frame_only:
        pre_warp = rng.random((2, 4 * H, 4 * W, 3), np.float32) - 0.5
    ref = np.asarray(jgen.generator_resnet_apply(
        jp, jnp.asarray(frame),
        None if frame_only else jnp.asarray(pre_warp),
        s2d_output=s2d_output))
    got = tgen.generator_resnet_apply(
        tp, _t(frame), None if frame_only else _t(pre_warp),
        s2d_output=s2d_output)
    assert got.shape == ((2, H, W, 48) if s2d_output
                         else (2, 4 * H, 4 * W, 3))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    wrong = None
    if frame_only:  # a pre_warp for params prepared without one
        wrong = _t(np.zeros((2, H, W, 48) if s2d_output
                            else (2, 4 * H, 4 * W, 3), np.float32))
    with pytest.raises(ValueError, match="frame_only"):
        tgen.generator_resnet_apply(tp, _t(frame), wrong,
                                    s2d_output=s2d_output)


# (window, norm, luma_normalize, gain, limit)
_MA_CASES = [(0, "l1", False, 0.0, False), (0, "l2", True, 0.0, True),
             (4, "l1", False, 0.0, False), (4, "l2", True, 0.0, False),
             (0, "l1", True, 5.0, False), (4, "l1", False, 5.0, True)]


def _ma_inputs(rng, window, norm, luma, shape):
    """gen and pre_warp whose scene-change decisions sit well away from
    the threshold: |diff| is 0.02 or 0.4 (+-25%) per frame (window 0) or
    per window, so a hard gate cannot flip on round-off."""
    n, h, w, _ = shape
    warp = (rng.random(shape, np.float32) - 0.5) * 0.6
    win = window or max(h, w)
    amp = rng.choice([0.02, 0.4], size=(n, -(-h // win) + 1,
                                        -(-w // win) + 1))
    amp[0, 0, 0], amp[-1, 0, 0] = 0.02, 0.4  # both sides occur
    yy = (np.arange(h) + (-(-h // win) * win - h) // 2) // win
    xx = (np.arange(w) + (-(-w // win) * win - w) // 2) // win
    a = amp[:, yy][:, :, xx][..., None]
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    diff = (sign * a * (0.75 + 0.5 * rng.random(shape))).astype(np.float32)
    # The gate's input as the reference computes it, in float64.
    d = np.abs(diff) if norm == "l1" else diff.astype(np.float64) ** 2
    lw = np.asarray(jtemporal.BGR_LUMA) * 3.0
    wts = (lw * (lw if norm == "l2" else 1.0)) if luma else np.ones(3)
    wd = (d * wts).astype(np.float64)
    if window == 0:
        means = wd.mean(axis=(1, 2, 3))
    else:
        ph, pw = -(-h // win) * win, -(-w // win) * win
        pad = np.zeros((n, ph, pw, 3))
        pt, pl = (ph - h) // 2, (pw - w) // 2
        pad[:, pt:pt + h, pl:pl + w] = wd
        means = pad.reshape(n, ph // win, win, pw // win, win, 3).mean(
            axis=(2, 4, 5))
    return warp + diff, warp, means


@pytest.mark.parametrize("window,norm,luma,gain,limit", _MA_CASES)
@pytest.mark.parametrize("form", ["pixel", "s2d"])
def test_frame_moving_avg_matches_jax(rng, window, norm, luma, gain, limit,
                                      form):
    """f32 within 1e-5, on pixel tensors and through the s2d model's
    route (window 0 on a reshaped view, a window through d2s/s2d).  The
    hard gate's window means stay at least 0.01 from the threshold."""
    cfg = {"strength": 0.7, "window": window, "threshold": 0.1,
           "gain": gain, "norm": norm, "limit": limit,
           "luma_normalize": luma}
    # 22 columns pad to 24 for a window of 4; the s2d form needs 20.
    shape = (2, 16, 22 if form == "pixel" else 20, 3)
    gen, warp, means = _ma_inputs(rng, window, norm, luma, shape)
    if gain == 0:
        assert np.abs(means - 0.1).min() > 0.01
        assert (means < 0.1).any() and (means > 0.1).any()
    jcfg = jtemporal.FrameMovingAvgConfig(**cfg)
    tcfg = ttemporal.FrameMovingAvgConfig(**cfg)
    if form == "pixel":
        ref = np.asarray(jtemporal.frame_moving_avg(
            jnp.asarray(gen), jnp.asarray(warp), jcfg))
        got = ttemporal.frame_moving_avg(_t(gen), _t(warp), tcfg).numpy()
    else:
        gs, ws = (np.asarray(space_to_depth(jnp.asarray(a), 4))
                  for a in (gen, warp))
        jm = JModel(None, None, frame_moving_avg=jcfg, s2d_mode=True)
        tm = InferenceModel(None, None, frame_moving_avg=tcfg)
        ref = np.asarray(jm._moving_avg_s2d(jnp.asarray(gs), jnp.asarray(ws)))
        got = tm._moving_avg(_t(gs), _t(ws)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ---- the engine, recurrent ---------------------------------------------


_VARIANTS = {
    "u8_state": _config(u8_state=True),
    "moving_avg_global": _config(frame_moving_avg=MA),
    "moving_avg_window": _config(frame_moving_avg={**MA, "window": 4}),
    "output_flow": _config(output_flow=True),
    "remove_flow": _no_flow_config(),
    "pixel_mode": _config(s2d_mode=False),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_variant_engine_matches_jax_recurrent(rng, name):
    """6 recurrent frames in f32: u8 within 1 step (f32 round-off can
    tip a truncating cast by one)."""
    j_engine, t_engine = engines(_VARIANTS[name])
    assert t_engine._deferred == (name not in ("remove_flow",
                                               "pixel_mode"))
    for frame in u8_frames(rng, 6, H, W):
        got = t_engine.process(frame)
        assert got.shape == (4 * H, 4 * W, 3)
        assert u8_diff(got, j_engine.process(frame)).max() <= 1


def test_variant_states():
    """Each variant's initial state, as the reference's init_state."""
    def state(config):
        return create_models(config)["inference"].obj.init_state(
            2, device="cpu")

    u8 = state(_VARIANTS["u8_state"])
    assert u8["pre_gen"].dtype == torch.uint8
    assert bool((u8["pre_gen"] == 127).all())
    assert u8["pre_gen"].shape == (2, H, W, 48)
    assert state(_VARIANTS["remove_flow"]) == {}
    px = state(_VARIANTS["pixel_mode"])
    assert px["pre_gen"].shape == (2, 4 * H, 4 * W, 3)
    assert [f.shape for f in px["last_frames"]] == [(2, H, W, 3)] * 3


def test_reset_restores_the_u8_state_mid_stream(rng):
    """reset() re-creates the state from init_state (u8 127, not 0), in
    the engine's own buffers: the frames after it equal a fresh
    engine's."""
    config = _config(u8_state=True, normalize_brightness=True)
    _, flat = flat_params(config)
    model = create_models(config)["inference"].obj
    params = from_flat_numpy(flat)
    engine = Engine(model, params, device="cpu")
    frames = u8_frames(rng, 6, H, W)
    for f in frames[:3]:
        engine.process(f)
    buffers = [engine.state["pre_gen"]] + list(engine.state["last_frames"])
    engine.reset()
    assert bool((engine.state["pre_gen"] == 127).all())
    assert all(float(b.abs().max()) == 0.0
               for b in engine.state["last_frames"])
    assert {id(b) for b in buffers} == (
        {id(engine.state["pre_gen"])}
        | {id(b) for b in engine.state["last_frames"]})
    fresh = Engine(model, params, device="cpu")
    for f in frames[3:]:
        np.testing.assert_array_equal(engine.process(f), fresh.process(f))


def test_remove_flow_engine_has_no_state(rng):
    """The non-temporal variant: no flow params prepared, an empty state
    that reset() and step() leave empty, the u8 HR frame from the step
    (no deferred display) and a clip equal to streaming."""
    _, t_engine = engines(_no_flow_config())
    assert "flow" not in t_engine.params and t_engine.state == {}
    frames = u8_frames(rng, 3, H, W)
    streamed = np.stack([t_engine.process(f) for f in frames])
    t_engine.reset()
    assert t_engine.state == {}
    np.testing.assert_array_equal(t_engine.process_clip(frames), streamed)
