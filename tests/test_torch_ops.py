"""Port parity: image, space/depth, resize and layer ops vs the JAX package.

Inputs come from numpy and are fed to both packages; every tolerance is
stated with its reason.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from joshupscale_tpu.nn import layers as jlayers
from joshupscale_tpu.ops import image as jimage
from joshupscale_tpu.ops import resize as jresize
from joshupscale_tpu.ops import space_depth as jsd
from joshupscale_torch.nn import layers as tlayers
from joshupscale_torch.ops import image as timage
from joshupscale_torch.ops import resize as tresize
from joshupscale_torch.ops import space_depth as tsd


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_preprocess_bit_exact():
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, -1)
    ref = np.asarray(jimage.preprocess(jnp.asarray(x)))
    got = timage.preprocess(_t(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_postprocess_bit_exact(rng, dtype):
    """Truncating u8 cast, bit for bit, including values that land on
    exact integers after x255 and values just below them."""
    k = np.arange(256, dtype=np.float32)
    on_grid = k / np.float32(255.0) - np.float32(0.5)
    below = np.nextafter(on_grid, np.float32(-1.0))
    mid = (k + np.float32(0.5)) / np.float32(255.0) - np.float32(0.5)
    rand = rng.random(1280, np.float32) - np.float32(0.5)
    x = np.clip(np.concatenate([on_grid, below, mid, rand]), -0.5, 0.5)
    x = x.astype(np.float32).reshape(1, 8, -1, 4)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    ref = np.asarray(jimage.postprocess(jx))
    got = timage.postprocess(tx).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("block", [2, 4])
def test_space_depth_exact(rng, block):
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    s2d = tsd.space_to_depth(_t(x), block).numpy()
    np.testing.assert_array_equal(
        s2d, np.asarray(jsd.space_to_depth(jnp.asarray(x), block)))
    y = rng.standard_normal((2, 4, 6, block * block * 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tsd.depth_to_space(_t(y), block).numpy(),
        np.asarray(jsd.depth_to_space(jnp.asarray(y), block)))
    np.testing.assert_array_equal(
        tsd.depth_to_space(_t(s2d), block).numpy(), x)


def test_pixel_shuffle_is_not_dcr(rng):
    """torch.pixel_shuffle (CRD order) would scramble channels."""
    y = rng.standard_normal((1, 4, 6, 48)).astype(np.float32)
    ours = tsd.depth_to_space(_t(y), 4)
    crd = torch.pixel_shuffle(_t(y).permute(0, 3, 1, 2), 4).permute(
        0, 2, 3, 1)
    assert ours.shape == crd.shape
    assert not torch.equal(ours, crd)


@pytest.mark.parametrize("skip_d2s", [False, True])
def test_upscale_bilinear_conv(rng, skip_d2s):
    """f32 within 1e-6: a 2x2 conv whose sums run in another order."""
    x = rng.random((2, 8, 12, 3), np.float32) - 0.5
    ref = np.asarray(jresize._upscale_bilinear_conv(
        jnp.asarray(x), 4, skip_d2s=skip_d2s))
    got = tresize._upscale_bilinear_conv(_t(x), 4, skip_d2s=skip_d2s)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    if not skip_d2s:
        np.testing.assert_allclose(
            tresize.upscale_bilinear(_t(x), 4).numpy(),
            np.asarray(jresize.upscale_bilinear(jnp.asarray(x), 4)),
            atol=1e-6, rtol=0)


def test_upscale_bilinear_wide_matches_jax(rng):
    """More than 8 channels (the broadcast form), f32 within 1e-6: the
    same four products summed in the same order."""
    x = rng.random((1, 4, 4, 16), np.float32) - 0.5
    np.testing.assert_allclose(
        tresize.upscale_bilinear(_t(x), 2).numpy(),
        np.asarray(jresize.upscale_bilinear(jnp.asarray(x), 2)),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("ksize,bias", [(3, False), (3, True), (1, True)])
def test_conv2d_same(rng, ksize, bias):
    """f32 within 1e-5: the same sums in another order."""
    k = rng.standard_normal((ksize, ksize, 12, 16)).astype(np.float32) * 0.2
    b = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((2, 8, 12, 12)).astype(np.float32)
    jp = {"kernel": jnp.asarray(k)}
    tp = {"kernel": _t(k.transpose(3, 0, 1, 2))}
    if bias:
        jp["bias"] = jnp.asarray(b)
        tp["bias"] = _t(b)
    ref = np.asarray(jlayers.conv2d(jp, jnp.asarray(x)))
    got = tlayers.conv2d(tp, _t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_batch_norm_and_activations(rng):
    """f32 within 1e-6: rsqrt may differ by an ulp between libraries."""
    bn = {"gamma": rng.random(8, np.float32) + 0.5,
          "beta": rng.standard_normal(8).astype(np.float32),
          "moving_mean": rng.standard_normal(8).astype(np.float32) * 0.1,
          "moving_variance": rng.random(8, np.float32) + 1.0}
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    ref = np.asarray(jlayers.batch_norm(
        {k: jnp.asarray(v) for k, v in bn.items()}, jnp.asarray(x)))
    got = tlayers.batch_norm({k: _t(v) for k, v in bn.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    for act in ("relu", "lrelu", {"name": "lrelu", "alpha": 0.2}):
        np.testing.assert_array_equal(
            tlayers.get_activation(act)(_t(x)).numpy(),
            np.asarray(jlayers.get_activation(act)(jnp.asarray(x))))
    with pytest.raises(ValueError):
        tlayers.get_activation("gelu")


def test_int8_params_raise(rng):
    """Int8 params (``kernel_q``, prepared once by
    ``prepare_conv_int8``) run the reference's int8 conv: bit for bit
    against its compiled form in f32 (more cases in
    ``test_torch_quantize``); an input whose channels the kernel does
    not take raises."""
    import jax

    from joshupscale_tpu.export.quantize import quantize_params_int8

    x = rng.standard_normal((1, 5, 6, 4)).astype(np.float32)
    jp = quantize_params_int8(
        {"kernel": jnp.asarray(rng.standard_normal((3, 3, 4, 8)),
                               jnp.float32)}, min_elements=0)
    tp = tlayers.prepare_conv_int8(
        {"kernel_q": _t(np.asarray(jp["kernel_q"]).transpose(3, 0, 1, 2)),
         "kernel_scale": _t(np.asarray(jp["kernel_scale"]))})
    ref = np.asarray(jax.jit(jlayers.conv2d)(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(tlayers.conv2d(tp, _t(x)).numpy(), ref)
    with pytest.raises(ValueError):
        tlayers.conv2d(tp, torch.zeros(1, 4, 4, 5))
