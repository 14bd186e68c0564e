"""``SpatialEngine`` (``joshupscale_torch/parallel/serving.py``): one
stream's frame split by rows over devices.

On ``["cpu"] * 2`` and ``["cpu"] * 4`` it must give the port's ``Engine``
frames bit for bit on every tier and serving option, and the JAX
``SpatialEngine`` on a 2- and 4-device CPU mesh (``tests/conftest.py``
forces 8 host devices) within the bound ``tests/test_torch_slice.py``
holds ``Engine`` to.  The places where a row split goes wrong are each
named in a test: K1 on a slab plus halo, global row coordinates, the
warp reading the whole previous output, the slab boundaries, library
convs on a slab's shape, the display.  Small nets use 32 filters: K1's
plain version takes C in {32, 48, 64} only.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import flat_params, u8_diff
from joshupscale_tpu.export.importer import unflatten_into
from joshupscale_tpu.parallel.serving import SpatialEngine as JSpatialEngine
from joshupscale_torch.export.quantize import quantize_params_int8
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.kernels.resblock import resblock_conv3x3
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.ops.resize import phase_kernel, phase_upscale
from joshupscale_torch.ops.resize import upscale_bilinear
from joshupscale_torch.ops.space_depth import depth_to_space
from joshupscale_torch.ops.warp import dense_image_warp, dense_image_warp_s2d
from joshupscale_torch.parallel import SpatialEngine
from joshupscale_torch.parallel.rows import Split
from joshupscale_torch.runtime.engine import Engine

H, W = 32, 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The slabs run many small ops; on a host shared with other test
    processes, intra-op thread pools then wait on each other far longer
    than the ops take, so this module runs them on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


AE ={"name": "flow-autoencoder", "num_inputs": 4,
      "filters": [16, 32, 32, 64, 32, 32, 16]}


def _config(flow=None, height=H, **inference):
    return {
        "flow": flow or {"name": "flow-resnet", "num_inputs": 4,
                         "num_filters": 32, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 2},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": height,
                      "frame_width": W, **inference},
    }


# The autoencoder tier's shape: 36 rows padded to 40 for 3 pooling
# stages, brightness normalized, bf16 as the PS2 tier files run it.
PS2 = dict(flow=AE, height=36, flow_pad_factor=8, normalize_brightness=True,
           compute_dtype="bfloat16")

OPTIONS = {
    "resnet_f32": {},
    "resnet_bf16": {"compute_dtype": "bfloat16"},
    "autoencoder": PS2,
    "u8_state": {"u8_state": True, "compute_dtype": "bfloat16"},
    "moving_avg_0": {"frame_moving_avg": {"window": 0}},
    "moving_avg_16": {"frame_moving_avg": {"window": 16, "gain": 2.0}},
    "output_flow": {"output_flow": True},
    "remove_flow": {"remove_flow": True},
    "pixel": {"s2d_mode": False},
    "inline_display": {"deferred_display": False},
    "skip_processing": {"skip_processing": True},
    "int8": {},
}


def _frames(model, rng, t):
    frames = rng.integers(0, 256, (t, model.frame_height,
                                   model.frame_width, 3)).astype(np.uint8)
    if model.skip_processing:
        return frames.astype(np.float32) / 255.0 - 0.5
    return frames


def _built(name):
    built = create_models(_config(**OPTIONS[name]), seed=3)["inference"]
    params = built.params
    if name == "int8":
        params = quantize_params_int8(params, min_elements=1)
    return built.obj, params


@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_spatial_engine_equals_engine(rng, option, slabs):
    """Every tier shape and serving option, 4 recurrent frames, a
    ``reset`` and a frame again: bit for bit with ``Engine``.  The warp
    reads the whole previous output (gathered once a frame), so a flow
    that crosses a slab boundary reads the neighbour's rows."""
    model, params = _built(option)
    spatial = SpatialEngine(model, params, devices=["cpu"] * slabs)
    engine = Engine(model, params, device="cpu")
    frames = _frames(model, rng, 4)
    outs = [spatial.process(f) for f in frames]
    for f, out in zip(frames, outs):
        want = engine.process(f)
        assert out.shape == want.shape == (4 * model.frame_height,
                                           4 * model.frame_width, 3)
        assert out.dtype == want.dtype
        np.testing.assert_array_equal(out, want)
    spatial.reset()
    np.testing.assert_array_equal(spatial.process(frames[0]), outs[0])
    assert spatial.frames_processed == 5


def _both(config):
    built, flat = flat_params(config, seed=5)
    t_model = create_models(config, seed=5)["inference"].obj
    return (built.obj, unflatten_into(built.params, flat), t_model,
            from_flat_numpy(flat))


@pytest.mark.parametrize("slabs", [2, 4])
@pytest.mark.parametrize("tier", ["resnet_f32", "autoencoder"])
def test_spatial_engine_matches_jax_spatial_engine(rng, tier, slabs):
    """The port on ``slabs`` CPU slabs against the JAX ``SpatialEngine``
    on a ``slabs``-device mesh: f32 within 1 u8 step, bf16 within 2 and
    on at most 10% of the values (``tests/test_torch_slice.py``'s
    bounds for ``Engine``)."""
    j_model, j_params, t_model, t_params = _both(_config(**OPTIONS[tier]))
    ref = JSpatialEngine(j_model, j_params,
                         mesh=Mesh(np.asarray(jax.devices()[:slabs]), ("sp",)))
    spatial = SpatialEngine(t_model, t_params, devices=["cpu"] * slabs)
    for frame in _frames(t_model, rng, 3):
        diff = u8_diff(spatial.process(frame), ref.process(frame))
        if tier == "resnet_f32":
            assert diff.max() <= 1
        else:
            assert diff.max() <= 2 and (diff > 0).mean() <= 0.10


def test_slab_boundaries():
    """LR rows; on the autoencoder, flow slabs on multiples of the
    pooling factor of the padded height (uneven where they must be),
    the frame's slabs those less the padding rows.  At the tiers' full
    size: quality 270 rows in 2 and 4 slabs, the PS2 tiers' 272."""
    model, params = _built("autoencoder")
    spatial = SpatialEngine(model, params, devices=["cpu"] * 4)
    assert spatial.flow_split.bounds == (0, 8, 16, 24, 40)
    assert spatial.split.bounds == (0, 6, 14, 22, 36)
    quality = create_models(_config(height=270), seed=0)["inference"]
    ps2 = create_models(_config(**{**PS2, "height": 270}), seed=0)[
        "inference"]
    for built, slabs, flow, frame in (
            (quality, 2, (0, 135, 270), (0, 135, 270)),
            (quality, 4, (0, 67, 135, 202, 270), (0, 67, 135, 202, 270)),
            (ps2, 2, (0, 136, 272), (0, 135, 270)),
            (ps2, 4, (0, 64, 136, 200, 272), (0, 63, 135, 199, 270))):
        s = SpatialEngine(built.obj, built.params, devices=["cpu"] * slabs)
        assert s.flow_split.bounds == flow and s.split.bounds == frame
    with pytest.raises(ValueError, match="too short"):
        SpatialEngine(model, params, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="multiple of 2"):
        Split((0, 3, 6), ["cpu", "cpu"]).scaled(1, 2)


def test_k1_on_row_slab_plus_halo(rng):
    """K1 (its plain version here; the kernel in ``test_torch_cuda.py``)
    on ``(1, rows + 2, W, C)`` slabs with their real halo rows, conv_2's
    residual the same slab plus halo: the interior rows are the whole
    frame's, bit for bit."""
    c = 32
    x = torch.from_numpy(rng.standard_normal((1, 17, 12, c)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((c, 3, 3, c)).astype(
        np.float32) * 0.1).bfloat16()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    offset = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    whole = resblock_conv3x3(resblock_conv3x3(x, w, scale, offset), w,
                             scale, offset, x)
    split = Split((0, 5, 11, 17), ["cpu"] * 3)
    xs = split.scatter(x)
    ys = split.with_halo(
        lambda i, t: resblock_conv3x3(t, w, scale, offset), [xs], 1, 1)
    out = split.with_halo(
        lambda i, t, r: resblock_conv3x3(t, w, scale, offset, r),
        [ys, xs], 1, 1)
    assert torch.equal(split.gather(out, "cpu"), whole)


def test_global_row_coordinates(rng):
    """The warps at a slab's global rows (``row0``), with flows of ~10
    rows that read across slab boundaries and past the frame's edges
    (clamped there, in f32 index math), on float and u8 s2d tables and
    the pixel form; the TF1 x4 phase upscale and the autoencoder's x2
    f32 upscale on slab plus 1 halo row below: each slab's rows are the
    whole frame's."""
    hb, wb = 12, 6
    table = torch.from_numpy(rng.standard_normal((1, hb, wb, 48)).astype(
        np.float32))
    u8 = torch.from_numpy(rng.integers(0, 256, (1, hb, wb, 48)).astype(
        np.uint8))
    flow = torch.from_numpy(rng.normal(0, 10, (1, hb, wb, 32)).astype(
        np.float32))
    pixel = torch.from_numpy(rng.standard_normal((1, 4 * hb, 4 * wb, 3))
                             .astype(np.float32))
    pflow = depth_to_space(flow, 4)
    split = Split((0, 5, 12), ["cpu", "cpu"])
    for image in (table, table.bfloat16(), u8):
        whole = dense_image_warp_s2d(image, flow)
        slabs = [dense_image_warp_s2d(image, f, row0=a) for f, (a, _) in
                 zip(split.scatter(flow), map(split.rows, (0, 1)))]
        assert torch.equal(torch.cat(slabs, 1), whole)
    hr = split.scaled(4)
    whole = dense_image_warp(pixel, pflow)
    slabs = [dense_image_warp(pixel, f, row0=hr.rows(i)[0])
             for i, f in enumerate(hr.scatter(pflow))]
    assert torch.equal(torch.cat(slabs, 1), whole)

    frame = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, hb, wb, 3)).astype(
        np.float32)).bfloat16()
    kernel = phase_kernel(4, 3, torch.bfloat16)
    up = split.with_halo(lambda i, f: phase_upscale(f, kernel),
                         [split.scatter(frame)], 0, 1)
    assert torch.equal(split.gather(up, "cpu"), phase_upscale(frame, kernel))
    wide = torch.from_numpy(rng.standard_normal((1, hb, wb, 32)).astype(
        np.float32)).bfloat16()
    up2 = split.with_halo(
        lambda i, t: upscale_bilinear(t.float(), 2).to(t.dtype),
        [split.scatter(wide)], 0, 1, 2)
    assert torch.equal(split.gather(up2, "cpu"),
                       upscale_bilinear(wide.float(), 2).bfloat16())


def test_library_conv_on_small_f32_slabs(rng):
    """The one place the CPU does not give the bytes: in float32,
    oneDNN's conv picks another kernel (another summation order) for
    problems of a few hundred pixels, so the autoencoder's lowest levels
    on 4 slabs (2-row slabs at 10 x 12) differ from the whole frame's in
    the last bits.  The taps name the first layer that differs, a conv
    block of the low level, and the frames stay within 1 u8 step; on 2
    slabs they are bit for bit."""
    model, params = _built("autoencoder")
    import dataclasses

    model = dataclasses.replace(model, compute_dtype=torch.float32)
    one = SpatialEngine(model, params, devices=["cpu"])
    two = SpatialEngine(model, params, devices=["cpu"] * 2)
    four = SpatialEngine(model, params, devices=["cpu"] * 4)
    first = []
    for frame in _frames(model, rng, 2):
        one.taps, four.taps = {}, {}
        want = one.process(frame)
        np.testing.assert_array_equal(two.process(frame), want)
        assert u8_diff(four.process(frame), want).max() <= 1
        first.append(next((k for k in one.taps
                           if not torch.equal(one.taps[k], four.taps[k])),
                          None))
    assert first[0] is not None and first[0].startswith("flow.block_")
    assert list(one.taps)[0] == "flow.block_1"


def test_spatial_engine_api(rng, monkeypatch):
    """Shapes, ``reset``, bad frames, and no device by default without
    a card: ``SpatialEngine()`` raises rather than run on the CPU."""
    model, params = _built("resnet_bf16")
    spatial = SpatialEngine(model, params, devices=["cpu", "cpu"])
    assert spatial.input_shape == (1, H, W, 3)
    assert spatial.output_shape == (1, 4 * H, 4 * W, 3)
    frame = _frames(model, rng, 1)
    assert spatial.process(frame).shape == (4 * H, 4 * W, 3)
    assert spatial.process(frame[0]).shape == (4 * H, 4 * W, 3)
    spatial.reset()
    assert all(float(t.abs().max()) == 0.0 for t in spatial.state["pre_gen"])
    with pytest.raises(ValueError, match="Invalid frame shape"):
        spatial.process(frame[0, :8])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpatialEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpatialEngine(model, params, devices=["cuda:0", "cuda:0"])
