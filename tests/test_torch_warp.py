"""Port parity: the s2d dense warp vs the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from joshupscale_tpu.ops.space_depth import depth_to_space, space_to_depth
from joshupscale_tpu.ops.warp import dense_image_warp, dense_image_warp_s2d
from joshupscale_torch.ops.warp import (
    dense_image_warp_s2d as t_dense_image_warp_s2d,
)


def _case(rng, n, hb, wb, reach, integer=False):
    """Image + flow in s2d form; |flow| up to ``reach`` x frame size."""
    h, w = hb * 4, wb * 4
    image = rng.random((n, h, w, 3), np.float32) - 0.5
    scale = np.array([h, w], np.float32) * reach
    flow = (rng.random((n, h, w, 2), np.float32) * 2 - 1) * scale
    if integer:
        flow = np.round(flow)
    flow = flow.astype(np.float32)
    img_s = np.array(space_to_depth(jnp.asarray(image), 4))
    flow_s = np.array(space_to_depth(jnp.asarray(flow), 4))
    return image, flow, img_s, flow_s


@pytest.mark.parametrize("n,reach,integer", [
    (1, 0.1, False),   # small in-frame motion
    (2, 1.5, False),   # past every edge, batch 2
    (2, 0.5, True),    # integer flows: floor boundaries
])
def test_warp_s2d_f32(rng, n, reach, integer):
    """f32 within 1e-5: the same f32 index math and 25-term combine."""
    _, _, img_s, flow_s = _case(rng, n, 4, 6, reach, integer)
    ref = np.asarray(dense_image_warp_s2d(jnp.asarray(img_s),
                                          jnp.asarray(flow_s)))
    got = t_dense_image_warp_s2d(torch.from_numpy(img_s),
                                 torch.from_numpy(flow_s))
    assert got.dtype == torch.float32 and got.shape == img_s.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_warp_s2d_matches_pixel_warp(rng):
    """The port's s2d warp equals the JAX pixel-space warp (tfa
    semantics) after depth_to_space, f32 within 1e-5."""
    image, flow, img_s, flow_s = _case(rng, 1, 4, 6, 0.7)
    ref = np.asarray(dense_image_warp(jnp.asarray(image),
                                      jnp.asarray(flow)))
    got = t_dense_image_warp_s2d(torch.from_numpy(img_s),
                                 torch.from_numpy(flow_s))
    got_px = np.asarray(depth_to_space(jnp.asarray(got.numpy()), 4))
    np.testing.assert_allclose(got_px, ref, atol=1e-5, rtol=0)


def test_warp_s2d_bf16_bound(rng):
    """bf16 within 0.02 (5 bf16 ulps at 0.5): both accumulate the
    25-term combine in bf16, but XLA:CPU may fuse it and round in f32,
    so bit-exactness is not expected."""
    _, _, img_s, flow_s = _case(rng, 2, 4, 6, 0.5)
    ref = np.asarray(dense_image_warp_s2d(
        jnp.asarray(img_s, jnp.bfloat16), jnp.asarray(flow_s)),
        np.float32)
    got = t_dense_image_warp_s2d(
        torch.from_numpy(img_s).to(torch.bfloat16), torch.from_numpy(flow_s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.02, rtol=0)


def test_warp_u8_table_matches_jax(rng):
    """The u8 table (the u8-state tier): bf16 out, within 0.02 of the
    reference (both combine raw 0..255 values in bf16, an ulp of 1 above
    128, then one f32 affine /255 - 0.5; XLA:CPU may fuse the bf16
    combine and round in f32)."""
    _, _, _, flow_s = _case(rng, 2, 4, 6, 0.5)
    img_u8 = rng.integers(0, 256, (2, 4, 6, 48)).astype(np.uint8)
    ref = np.asarray(dense_image_warp_s2d(jnp.asarray(img_u8),
                                          jnp.asarray(flow_s)), np.float32)
    got = t_dense_image_warp_s2d(torch.from_numpy(img_u8),
                                 torch.from_numpy(flow_s))
    assert got.dtype == torch.bfloat16 and got.shape == img_u8.shape
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.02, rtol=0)
