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


# -- K3 (kernels/warp.py, csrc/warp_s2d.cu): its formula and its dispatch --


def _four_corners(image, flow, row0=0):
    """The kernel's formula (``csrc/warp_s2d.cu``) in torch: the four
    live corners read straight from the s2d image, each product and sum
    in float32 and rounded to the compute type at the kernel's places,
    in its order."""
    n, hb, wb, _ = image.shape
    hq = flow.shape[1]
    cdt = torch.float32 if image.dtype == torch.float32 else torch.bfloat16
    r = lambda x: x.to(cdt).float()  # noqa: E731
    f = flow.float().reshape(n, hq, wb, 16, 2)
    phase = torch.arange(16)
    rows = torch.arange(row0, row0 + hq).view(1, hq, 1, 1) * 4 + phase // 4
    cols = torch.arange(wb).view(1, 1, wb, 1) * 4 + phase % 4

    def axis(q, size):
        fl = torch.clamp(torch.floor(q), 0.0, float(size - 2))
        return fl.long(), r(torch.clamp(q - fl, 0.0, 1.0))

    y, ay = axis(rows.float() - f[..., 0], hb * 4)
    x, ax = axis(cols.float() - f[..., 1], wb * 4)
    wy, wx = (r(1.0 - ay), ay), (r(1.0 - ax), ax)
    pix = image.float().reshape(n, hb, wb, 4, 4, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hb * 4, wb * 4, 3)
    b = torch.arange(n).view(n, 1, 1, 1)
    acc = torch.zeros((n, hq, wb, 16, 3))
    for dy in range(2):
        for dx in range(2):
            w = r(wy[dy] * wx[dx])[..., None]
            acc = r(acc + r(pix[b, y + dy, x + dx] * w))
    if image.dtype == torch.uint8:
        acc = acc * (1.0 / 255.0) - 0.5
    return acc.to(cdt).reshape(n, hq, wb, 48)


_FORMULA_CASES = [
    (img, flo, reach, integer)
    for img, flo in [(torch.float32, torch.float32),
                     (torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32),
                     (torch.uint8, torch.bfloat16),
                     (torch.uint8, torch.float32)]
    for reach, integer in [(0.1, False), (1.5, False), (0.5, True)]]


@pytest.mark.parametrize("image_dtype,flow_dtype,reach,integer",
                         _FORMULA_CASES)
def test_four_live_corners_equal_the_25_term_combine(rng, image_dtype,
                                                     flow_dtype, reach,
                                                     integer):
    """The premise of K3: the four live corners, rounded as the kernel
    rounds them and summed in its order, equal the plain path's 25-term
    combine bit for bit (its other 21 terms add exact zeros), for float32,
    bfloat16 and uint8 tables, flows within the frame, past every edge
    (the clamp) and on integers (floor boundaries), on an odd small
    frame, at batch 2."""
    _, flow, img_s, flow_s = _case(rng, 2, 5, 7, reach, integer)
    if image_dtype == torch.uint8:
        image = torch.from_numpy(rng.integers(0, 256, img_s.shape).astype(
            np.uint8))
    else:
        image = torch.from_numpy(img_s).to(image_dtype)
    flow_t = torch.from_numpy(flow_s).to(flow_dtype)
    got = t_dense_image_warp_s2d(image, flow_t)
    want = _four_corners(image, flow_t)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("image_dtype", [torch.float32, torch.bfloat16,
                                         torch.uint8])
def test_four_live_corners_on_a_row_slab(rng, image_dtype):
    """The same on a row slab (``row0``, ``SpatialEngine``'s form): the
    slab's queries use its global rows and read the whole image."""
    _, _, img_s, flow_s = _case(rng, 1, 6, 5, 0.4)
    image = (torch.from_numpy(rng.integers(0, 256, img_s.shape).astype(
        np.uint8)) if image_dtype == torch.uint8
        else torch.from_numpy(img_s).to(image_dtype))
    slab = torch.from_numpy(flow_s)[:, 2:5]
    got = t_dense_image_warp_s2d(image, slab, row0=2)
    assert torch.equal(got, _four_corners(image, slab, row0=2))


def test_warp_s2d_on_the_cpu_runs_the_plain_ops(rng):
    """CPU tensors, with or without a gradient to take, run the plain
    torch ops: the kernel's counter does not move."""
    from joshupscale_torch.kernels.warp import takes, warp_s2d
    from joshupscale_torch.ops.warp import dense_image_warp_s2d_plain

    _, _, img_s, flow_s = _case(rng, 1, 4, 6, 0.5)
    before = warp_s2d.launches
    for dtype in (torch.float32, torch.bfloat16):
        image = torch.from_numpy(img_s).to(dtype)
        flow = torch.from_numpy(flow_s)
        assert not takes(image, flow, 4)
        assert torch.equal(t_dense_image_warp_s2d(image, flow),
                           dense_image_warp_s2d_plain(image, flow))
    image = torch.from_numpy(img_s).requires_grad_()
    out = t_dense_image_warp_s2d(image, torch.from_numpy(flow_s))
    out.sum().backward()
    assert image.grad is not None
    assert warp_s2d.launches == before


def _card_like(shape, dtype, grad=False, rows=None):
    """A fake CUDA tensor; ``rows``: the rows of a taller buffer it is a
    crop of (the strides of ``flow[:, 1:-1]`` on a padded grid)."""
    n, h, w, c = shape
    stride = ((rows or h) * w * c, w * c, c, 1)
    return torch.empty_strided(shape, stride, dtype=dtype, device="cuda",
                               requires_grad=grad)


@pytest.mark.parametrize("image_dtype", [torch.float32, torch.bfloat16,
                                         torch.uint8])
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
def test_warp_s2d_on_card_tensors_reaches_the_kernel_op(monkeypatch,
                                                        image_dtype,
                                                        flow_dtype):
    """On card tensors (fake CUDA tensors, as ``torch.export`` traces
    them) without a gradient to take, ``dense_image_warp_s2d`` calls the
    kernel's wrapper, whose op gives the output's shape and type
    (``csrc/torch_ops.cpp``'s Meta implementation), a cropped (strided)
    flow and a row slab included; a trace launches nothing, so the
    counter stays."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from joshupscale_torch.kernels import warp as kwarp

    calls = []
    real = kwarp.warp_s2d

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(kwarp, "warp_s2d", spy)
    before = real.launches
    want = torch.float32 if image_dtype == torch.float32 else torch.bfloat16
    with FakeTensorMode():
        image = _card_like((2, 6, 5, 48), image_dtype)
        flow = _card_like((2, 6, 5, 32), flow_dtype, rows=8)
        assert not flow.is_contiguous()
        out = t_dense_image_warp_s2d(image, flow)
        slab = t_dense_image_warp_s2d(
            image, _card_like((2, 2, 5, 32), flow_dtype, rows=8), row0=2)
    assert len(calls) == 2
    assert tuple(out.shape) == (2, 6, 5, 48) and out.dtype == want
    assert tuple(slab.shape) == (2, 2, 5, 48) and slab.dtype == want
    assert real.launches == before


def test_warp_s2d_dispatch_keeps_the_plain_ops_where_the_kernel_cannot():
    """On card tensors the plain ops run where a gradient is to be taken
    (training's ``_SegsumGather`` backward), for another block or channel
    count and for a float16 image; without grad the kernel serves."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from joshupscale_torch.kernels.warp import takes

    with FakeTensorMode():
        image = _card_like((1, 4, 6, 48), torch.bfloat16, grad=True)
        flow = _card_like((1, 4, 6, 32), torch.bfloat16)
        assert not takes(image, flow, 4)
        assert not takes(image.detach(), flow.requires_grad_(), 4)
        with torch.no_grad():
            assert takes(image, flow, 4)
        image, flow = image.detach(), flow.detach()
        assert takes(image, flow, 4)
        assert not takes(image, flow, 2)
        assert not takes(_card_like((1, 4, 6, 24), torch.bfloat16), flow, 4)
        assert not takes(_card_like((1, 4, 6, 48), torch.float16), flow, 4)


@pytest.mark.parametrize("image_dtype,flow_dtype,block_bytes", [
    (torch.bfloat16, torch.bfloat16, 32 * 2 + 48 * 2 + 48 * 2),
    (torch.bfloat16, torch.float32, 32 * 4 + 48 * 2 + 48 * 2),
    (torch.uint8, torch.bfloat16, 32 * 2 + 48 * 1 + 48 * 2),
    (torch.float32, torch.float32, 32 * 4 + 48 * 4 + 48 * 4),
])
def test_chip_smoke_k3_bound_counts_each_operand_in_its_type(
        image_dtype, flow_dtype, block_bytes):
    """``chip_smoke.py``'s K3 byte bound reads the flow and the image in
    the types it is handed and writes float32 for a float32 image, else
    bfloat16: 9.9 us at (1, 270, 480) in bf16 at 3.35 TB/s."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    got = smoke.k3_bound_ms(2, 270, 480, size(image_dtype), size(flow_dtype))
    assert got == pytest.approx(2 * 270 * 480 * block_bytes / 3.35e12 * 1e3,
                                rel=1e-12)
    if (image_dtype, flow_dtype) == (torch.bfloat16, torch.bfloat16):
        assert smoke.k3_bound_ms(1, 270, 480, 2, 2) == pytest.approx(
            9.9e-3, rel=1e-3)
