"""Port parity for the modules that hold a CUDA kernel.

K1 (``kernels/resblock.py``, the res-block conv) and K2
(``kernels/display.py``, d2s + u8 display): their plain versions --
what a CPU tensor runs -- are held against the JAX package; the kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from joshupscale_tpu.export.importer import flatten_params
from joshupscale_tpu.models.common import (
    Mutables,
    res_block_init,
    res_blocks_apply as j_res_blocks_apply,
)
from joshupscale_tpu.nn import resblock_pallas
from joshupscale_tpu.ops.display import d2s_display_u8 as j_d2s_display_u8
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.kernels.display import d2s_display_u8
from joshupscale_torch.kernels.resblock import (
    resblock_conv3x3,
    resblock_conv3x3_plain,
)
from joshupscale_torch.models.common import (
    fade_scale,
    fold_res_block,
    prepare_res_blocks,
    res_blocks_apply as t_res_blocks_apply,
)
from joshupscale_torch.nn.layers import fold_bn


def _jax_blocks(rng, c, bias=False, seed=1):
    """Two res blocks (the second with a fade at counter 4 of 10), BN
    stats perturbed; optionally conv biases as imported weights carry."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"block_1": res_block_init(k1, c),
              "block_2": res_block_init(k2, c, fade_in_period=10)}
    params["block_2"]["fade"]["counter"] = jnp.asarray(4.0, jnp.float32)
    for blk in params.values():
        for bn in ("bn_1", "bn_2"):
            blk[bn]["moving_mean"] = jnp.asarray(
                rng.standard_normal(c) * 0.1, jnp.float32)
            blk[bn]["moving_variance"] = jnp.asarray(
                1 + rng.random(c), jnp.float32)
            blk[bn]["gamma"] = jnp.asarray(
                0.5 + rng.random(c), jnp.float32)
        if bias:
            for conv in ("conv_1", "conv_2"):
                blk[conv]["bias"] = jnp.asarray(
                    rng.standard_normal(c) * 0.1, jnp.float32)
    return params


@pytest.mark.parametrize("c", [32, 48, 64])
@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_res_blocks_plain_matches_jax_f32(rng, c, act):
    """f32 within 1e-5: BN folded into the conv (JAX) vs into the
    epilogue (port) -- the same math, rounded in another order."""
    jp = _jax_blocks(rng, c, bias=(c == 48))
    names = ["block_1", "block_2"]
    x = rng.standard_normal((2, 6, 10, c)).astype(np.float32) * 0.5
    ref = np.asarray(j_res_blocks_apply(jp, names, jnp.asarray(x), act,
                                        Mutables(False)))
    tp = prepare_res_blocks(from_flat_numpy(flatten_params(jp)),
                            torch.float32)
    got = t_res_blocks_apply(tp, names, torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_res_blocks_plain_bf16_matches_pallas_chain(rng, act):
    """bf16 at C=64 vs the Pallas chain in interpret mode, within
    atol = rtol = 0.03: the Pallas kernel rounds the conv to bf16 and
    applies BN in bf16, the port keeps the epilogue in f32 and rounds
    once (the bound of tests/test_s2d_path.py for the same chain)."""
    jp = _jax_blocks(rng, 64)
    names = ["block_1", "block_2"]
    x = rng.standard_normal((2, 14, 16, 64)).astype(np.float32) * 0.5
    ref = resblock_pallas.res_block_chain(
        jp, names, jnp.asarray(x, jnp.bfloat16), act, interpret=True)
    tp = prepare_res_blocks(from_flat_numpy(flatten_params(jp)),
                            torch.bfloat16)
    got = t_res_blocks_apply(tp, names,
                             torch.from_numpy(x).to(torch.bfloat16), act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=0.03, rtol=0.03)


def _k1_operands(rng, c, dtype, shape=(1, 9, 20), device="cpu"):
    n, h, w = shape
    x = torch.from_numpy(
        rng.standard_normal((n, h, w, c)).astype(np.float32) * 0.5)
    wt = torch.from_numpy(
        rng.standard_normal((c, 3, 3, c)).astype(np.float32)
        / np.sqrt(9 * c))
    scale = torch.from_numpy(0.5 + rng.random(c).astype(np.float32))
    offset = torch.from_numpy(rng.standard_normal(c).astype(np.float32)
                              * 0.1)
    res = torch.from_numpy(
        rng.standard_normal((n, h, w, c)).astype(np.float32))
    to = dict(device=device)
    return (x.to(dtype=dtype, **to), wt.to(dtype=dtype, **to),
            scale.to(**to), offset.to(**to), res.to(dtype=dtype, **to))


def test_resblock_wrapper_checks(rng):
    x, w, s, t, r = _k1_operands(rng, 32, torch.float32)
    before = resblock_conv3x3.launches
    y = resblock_conv3x3(x, w, s, t, r, "lrelu", 0.3)
    np.testing.assert_array_equal(
        y.numpy(), resblock_conv3x3_plain(x, w, s, t, r, "lrelu", 0.3))
    assert resblock_conv3x3.launches == before  # the CPU ran no kernel
    with pytest.raises(ValueError):
        resblock_conv3x3(x[..., :16], w[:16, :, :, :16], s[:16], t[:16])
    with pytest.raises(ValueError):
        resblock_conv3x3(x, w.to(torch.bfloat16), s, t)
    with pytest.raises(ValueError):
        resblock_conv3x3(x, w, s, t, r[:, :4])
    with pytest.raises(ValueError):
        resblock_conv3x3(x, w, s, t, act="tanh")


def test_fold_res_block_form(rng):
    """K1's operands: the kernel cast to the compute dtype, scale and
    offset in f32 with the conv bias and the fade (4/10) folded in."""
    raw = from_flat_numpy(flatten_params(_jax_blocks(rng, 32, bias=True)))
    folded = prepare_res_blocks(raw, torch.bfloat16)
    assert sorted(folded) == ["block_1", "block_2"]
    blk, out = raw["block_2"], folded["block_2"]
    assert out["conv_1"]["kernel"].dtype == torch.bfloat16
    assert out["conv_2"]["scale"].dtype == torch.float32
    scale, offset = fold_bn(blk["bn_2"])
    fade = fade_scale(blk["fade"])
    assert float(fade) == pytest.approx(0.4)
    torch.testing.assert_close(out["conv_2"]["scale"], scale * fade)
    torch.testing.assert_close(
        out["conv_2"]["offset"],
        (offset + blk["conv_2"]["bias"] * scale) * fade)
    assert fold_res_block(raw["block_1"], torch.float32)[
        "conv_1"]["kernel"].dtype == torch.float32


def test_display_plain_matches_jax(rng):
    """Bit-exact: the same truncating u8 cast of the same f32 values,
    for (N, Hb, Wb, 48) and the stacked (T, N, Hb, Wb, 48) form."""
    x = np.clip(rng.standard_normal((3, 2, 4, 6, 48)).astype(np.float32)
                * 0.3, -0.5, 0.5)
    for dtype in ("float32", "bfloat16"):
        jx = jnp.asarray(x, getattr(jnp, dtype))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        ref = np.stack([np.asarray(j_d2s_display_u8(jx[t]))
                        for t in range(3)])
        np.testing.assert_array_equal(d2s_display_u8(tx).numpy(), ref)
        np.testing.assert_array_equal(d2s_display_u8(tx[0]).numpy(),
                                      ref[0])
    with pytest.raises(ValueError):
        d2s_display_u8(torch.zeros(1, 2, 2, 12))
