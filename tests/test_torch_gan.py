"""Port parity for TecoGAN training (``joshupscale_torch.training.gan``,
the GAN step, the discriminator, VGG19, the GAN losses, the play
callback, weight migration and the CLI's GAN branch).

The JAX package is the oracle.  Small nets as in
``tests/test_training.py``: flow and generator 8 filters x 1 res block,
discriminator ``alpha`` 0.25, VGG19 with random weights; batch 2, T = 10
(the 19-frame ping-pong), LR crop 8 (HR 32).  The reference's params
(moving statistics perturbed) are carried across with ``flatten_params``
-> ``from_flat_numpy`` and gradients come back through
``to_flat_numpy``.  The port takes its noise as tensors and these tests
feed the reference's draws.  Batches are u8 with saturated pixels; the
reference runs jitted on float batches that numpy normalized (a jitted
reference given u8 computes ``x / 255 - 0.5`` as an FMA that moves 255
off the clip's bound).  One module-scoped setup carries the params, and
the reference's forward-and-gradients program and its step are each
compiled once.

Bounds (float32 on both sides; the sums run in other orders): losses
within 2e-5 relative, moving statistics within 1e-5, forward tensors as
stated per case.  Gradients: each within 1e-4 relative L2, or within 3x
the reference's own conditioning where that is larger -- the largest
relative change of one of its gradients in the group when the first
convs' kernels move by +-1e-7 relative.  The generator group's
gradients are sensitive: the warp's gradient in the flow jumps where a
flow crosses an integer, a round-off difference moves a flow across
one, and the sums over 18 warps a step largely cancel.  With glorot heads the recurrence also amplifies round-off
(the outputs drift 1e-6 -> 2e-4 over the 19 frames and the reference's
gradients move by ~4% under a 1e-7 input change); the flow head and the
generator's last deconv are therefore scaled by 0.3 (a trained
generator's residual is small beside its bilinear skip), which keeps
the forward within ~1e-6 and the generator group's conditioning near
1e-3.  The play tests use 32 filters: K1's plain version takes C in
{32, 48, 64}.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joshupscale_tpu.export.importer import flatten_params, unflatten_into
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.models.discriminator import (
    discriminator_apply as j_discriminator_apply,
)
from joshupscale_tpu.models.common import Mutables as JMutables
from joshupscale_tpu.models.vgg import vgg19_apply as j_vgg19_apply
from joshupscale_tpu.nn import layers as j_layers
from joshupscale_tpu.training import losses as j_losses
from joshupscale_tpu.training.gan import (
    _group_channels as j_group_channels,
    _mask_border as j_mask_border,
    pingpong as j_pingpong,
)
from joshupscale_tpu.training.trainer import (
    GANTrainState as JGANTrainState,
    build_gan_step as j_build_gan_step,
    load_checkpoint as j_load_checkpoint,
    make_optimizer as j_make_optimizer,
    save_checkpoint as j_save_checkpoint,
)
from joshupscale_torch.export.weights import from_flat_numpy, to_flat_numpy
from joshupscale_torch.models.common import Mutables
from joshupscale_torch.models.discriminator import discriminator_apply
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.models.vgg import vgg19_apply
from joshupscale_torch.nn import layers
from joshupscale_torch.training import (
    GANTrainState,
    build_gan_step,
    init_gan_state,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)
from joshupscale_torch.training import losses
from joshupscale_torch.training.gan import (
    _group_channels,
    _mask_border,
    pingpong,
)
from joshupscale_torch.training.trainer import (
    _trainable_copy,
    gan_gradients,
)

B, T, CROP = 2, 10, 8
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-4
STAT_ATOL = 1e-5
LR = 1e-3


def _config(filters=8, **gan):
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": filters, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": filters,
                      "num_res_blocks": 1},
        "discriminator": {"name": "discriminator", "alpha": 0.25},
        "vgg": {"name": "vgg"},
        "gan": {"name": "gan", "flow": {"model": "flow"},
                "generator": {"model": "generator"},
                "discriminator": {"model": "discriminator"},
                "vgg": {"model": "vgg"}, **gan},
    }


# The flow and generator heads' damping (see the module docstring).
HEAD_SCALE = 0.3


def _perturb(flat, seed=7):
    """Moving statistics away from 0 / 1, so inference batch norm is no
    identity; the flow head and the generator's last deconv scaled by
    ``HEAD_SCALE``."""
    rng = np.random.default_rng(seed)
    flat = dict(flat)
    for k, v in flat.items():
        if k.endswith("moving_mean"):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            flat[k] = (1 + rng.random(v.shape)).astype(np.float32)
        elif k.endswith(("flow.conv_2.kernel",
                         "generator.conv_trans_2.kernel")):
            flat[k] = v * np.float32(HEAD_SCALE)
    return flat


def _batch(rng, b=B, t=T, crop=CROP):
    """u8 frames with saturated rows (0 and 255) in input and target."""
    inp = rng.integers(0, 256, (b, t, crop, crop, 3), dtype=np.uint8)
    tgt = rng.integers(0, 256, (b, t, 4 * crop, 4 * crop, 3),
                       dtype=np.uint8)
    inp[:, :, :2] = 255
    inp[:, :, -1] = 0
    tgt[:, :, :5] = 255
    tgt[:, :, -5:] = 0
    return {"input": inp, "target": tgt}


def _j(batch):
    """The reference's batch: u8 arrays normalized by numpy, exactly."""
    return {k: jnp.asarray(v.astype(np.float32) / np.float32(255)
                           - np.float32(0.5)) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j_noise(key, b=B, crop=CROP):
    """The reference's draws for ``key`` (``GANTrainer.forward``)."""
    k_hist, k_first = jax.random.split(key)
    noise = {"first_warp": jax.random.uniform(
        k_first, (b, 4 * crop, 4 * crop, 3), jnp.float32, -0.5, 0.5),
        "history": jax.random.uniform(k_hist, (b, 2, crop, crop, 3),
                                      jnp.float32, -0.5, 0.5)}
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _check_grads(j_grads, t_grads, rtol=GRAD_RTOL):
    got = to_flat_numpy(_nest(t_grads))
    want = flatten_params(j_grads)
    for path, ref in want.items():
        if path not in got:
            assert not np.any(ref), path
            continue
        assert _rel(got[path], ref) <= rtol, (path, _rel(got[path], ref))
    assert set(got) <= set(want)


def _check_updates(j_updates, t_updates, atol=STAT_ATOL):
    # A jitted reference returns its dicts with sorted keys.
    assert set(j_updates) == set(t_updates)
    for path, stats in j_updates.items():
        for stat, v in stats.items():
            np.testing.assert_allclose(_np(t_updates[path][stat]),
                                       np.asarray(v), atol=atol,
                                       err_msg=f"{path}.{stat}")


def _j_models(config):
    """The reference's ``create_models``, its VGG19 given zero weights of
    the reference's structure: its random init compiles for ~15 s on the
    CPU, and these tests carry the port's seeded VGG weights across
    instead (``_carried``)."""
    from unittest import mock

    import joshupscale_tpu.models.vgg as j_vgg

    def zeros(key, dtype=jnp.float32):
        from joshupscale_torch.models.vgg import vgg19_init

        flat = to_flat_numpy(vgg19_init(np.random.default_rng(0)))
        return _nest({k: jnp.zeros(v.shape, dtype) for k, v in flat.items()})

    with mock.patch.object(j_vgg, "vgg19_init", zeros):
        return j_create_models(config)


def _carried(j_params, t_params):
    """The reference's GAN params (moving statistics perturbed, heads
    damped) with the port's VGG weights, as the flat numpy dict."""
    flat = _perturb(flatten_params(j_params))
    flat.update(to_flat_numpy(t_params["vgg"], "vgg"))
    return flat


@pytest.fixture(scope="module")
def ref():
    """The reference's GAN entry with perturbed moving statistics, the
    port's entry carrying its params, a u8 batch, the reference's draws,
    and a cache for the compiled reference programs' results."""
    j_built = _j_models(_config())["gan"]
    t_built = create_models(_config())["gan"]
    flat = _carried(j_built.params, t_built.params)
    j_params = unflatten_into(j_built.params,
                              {k: jnp.asarray(v) for k, v in flat.items()})
    t_params = from_flat_numpy(flat)
    key = jax.random.PRNGKey(3)
    return types.SimpleNamespace(
        j=j_built, jp=j_params, t=t_built, tp=t_params,
        batch=_batch(np.random.default_rng(0)), key=key,
        noise=_j_noise(key), cache={})


def _j_all(trainer, ema):
    """The reference's forward, losses and both gradient pulls, jitted."""

    def fn(gp, dp, vp, inp, tgt, key):
        def loss_fn(g, d):
            y = trainer.forward(g, d, vp, inp, tgt, key, training=True)
            terms = trainer.compute_losses(y, ema)
            return (terms["gen_loss"], terms["discr_loss"]), (terms, y)

        (gl, _), vjp, (terms, y) = jax.vjp(loss_fn, gp, dp, has_aux=True)
        one, zero = jnp.ones_like(gl), jnp.zeros_like(gl)
        return terms, y, vjp((one, zero))[0], vjp((zero, one))[1]

    return jax.jit(fn)


def _port_all(trainer, tp, batch, noise, ema):
    """The port's forward, losses and both gradient pulls."""
    st = types.SimpleNamespace(gen_params=_trainable_copy(tp["gen"]),
                               discr_params=_trainable_copy(tp["discr"]))
    y = trainer.forward(st.gen_params, st.discr_params, tp["vgg"],
                        batch["input"], batch["target"], noise)
    terms = trainer.compute_losses(y, ema)
    gen, discr = gan_gradients(terms, st)
    return terms, y, gen, discr


def _nudged(gen, factor):
    """The generator group with both first convs' kernels times
    ``factor``."""
    return {net: {**p, "conv_1": {**p["conv_1"],
                                  "kernel": p["conv_1"]["kernel"] * factor}}
            for net, p in gen.items()}


def _reference_all(ref):
    """The reference's terms, forward, and gradients, and its own
    conditioning: for each group, the largest relative L2 change of a
    gradient when the first convs' kernels move by +-1e-7 relative."""
    if "all" not in ref.cache:
        jb = _j(ref.batch)
        ema = ref.j.obj.init_ema()
        fn = _j_all(ref.j.obj, ema)
        args = (ref.jp["discr"], ref.jp["vgg"], jb["input"], jb["target"],
                ref.key)
        ref.cache["all"] = fn(ref.jp["gen"], *args)
        nudged = [fn(_nudged(ref.jp["gen"], f), *args)
                  for f in (1 + 1e-7, 1 - 1e-7)]
        ref.cache["self"] = [
            max(_rel(b, a[k]) for n in nudged
                for k, b in flatten_params(n[i]).items() if np.any(a[k]))
            for i, a in ((i, flatten_params(ref.cache["all"][i]))
                         for i in (2, 3))]
        t_ema = {"t_balance1": torch.zeros(()), "t_balance2": torch.zeros(()),
                 "discr_steps": 0}
        ref.cache["port_all"] = _port_all(ref.t.obj, ref.tp, _t(ref.batch),
                                          ref.noise, t_ema)
    return ref.cache["all"], ref.cache["port_all"]


# ---------------------------------------------------------------------------
# Layers and models


@pytest.mark.parametrize("size,k,stride", [(24, 4, 2), (32, 4, 2),
                                           (3, 4, 2), (7, 3, 2), (9, 4, 1),
                                           (8, 3, 1)])
def test_conv2d_same_padding_and_stride_match_reference(rng, size, k,
                                                        stride):
    """TF ``SAME`` for even kernels and strides: asymmetric padding
    (one more after) where the total is odd (HR 24: block 4 goes 3 -> 2
    with padding (1, 2)); float32 within 1e-5."""
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 5, 6)).astype(np.float32) * 0.3
    bias = rng.standard_normal(6).astype(np.float32)
    want = j_layers.conv2d({"kernel": jnp.asarray(kernel),
                            "bias": jnp.asarray(bias)}, jnp.asarray(x),
                           stride=stride)
    got = layers.conv2d(
        from_flat_numpy({"c.kernel": kernel, "c.bias": bias})["c"],
        torch.from_numpy(x), stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_dense_and_max_pool_match_reference(rng):
    """``dense`` on an (in, out) kernel, and the 2x2 VALID max pool on
    an odd size (the last row and column dropped), bit for bit."""
    x = rng.standard_normal((2, 3, 3, 16)).astype(np.float32)
    p = {"kernel": rng.standard_normal((16, 1)).astype(np.float32),
         "bias": rng.standard_normal(1).astype(np.float32)}
    want = j_layers.dense({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    got = layers.dense(from_flat_numpy({f"dense.{k}": v for k, v in
                                        p.items()})["dense"],
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    y = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(y), -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    np.testing.assert_array_equal(
        layers.max_pool_2x2(torch.from_numpy(y)).numpy(), np.asarray(want))


@pytest.mark.parametrize("hr", [24, 32])
@pytest.mark.parametrize("training", [True, False],
                         ids=["train_bn", "inference_bn"])
def test_discriminator_matches_reference(ref, rng, hr, training):
    """The four block features and the logits, and the BN updates, on a
    27-channel input at HR 24 (asymmetric SAME padding in block 4) and
    32; float32 within 1e-5 (relative to the features' scale)."""
    x = rng.standard_normal((3, hr, hr, 27)).astype(np.float32) * 0.3
    j_mut = JMutables(training)
    want = j_discriminator_apply(ref.jp["discr"], jnp.asarray(x),
                                 mut=j_mut)
    mut = Mutables(training)
    got = discriminator_apply(ref.tp["discr"], torch.from_numpy(x), mut)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    _check_updates(j_mut.updates, mut.updates)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg19_matches_reference(ref, rng, dtype):
    """VGG19's four default layers on BGR frames in [-0.5, 0.5]: float32
    within 1e-5 relative L2 per layer; bf16 (activations and the caffe
    mean in bf16, params cast at each conv) within 2e-2."""
    x = (rng.random((2, 32, 32, 3)).astype(np.float32) - 0.5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.jit(j_vgg19_apply)(ref.jp["vgg"], jnp.asarray(x).astype(jdt))
    got = vgg19_apply(ref.tp["vgg"], torch.from_numpy(x).to(dtype))
    bound = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(_np(g), _np(w)) <= bound


def test_gan_losses_match_reference(rng):
    """Each GAN loss term against the reference's, values and gradients:
    logits at +-40 and 0 (the cross-entropy's tails), VGG feature rows
    near zero (the squared-norm clamp) and exactly zero, and the
    feature-matching norms."""
    logits = rng.standard_normal((4, 2, 2, 1)).astype(np.float32) * 3
    logits[0, 0, 0, 0], logits[0, 0, 1, 0] = 40.0, -40.0
    logits[1, 1, 1, 0] = 0.0
    feats_r = [rng.standard_normal((2, 3, 4, 5, c)).astype(np.float32)
               for c in (6, 8)]
    feats_f = [rng.standard_normal(f.shape).astype(np.float32)
               for f in feats_r]
    feats_f[0][0, 0, 0, 0] = 1e-5  # squared norm below 1e-7
    feats_r[1][1, 2, 3, 4] = 0.0
    layers_r = [rng.standard_normal((3, 4, 4, c)).astype(np.float32)
                for c in (4, 4, 8, 16)]
    layers_f = [rng.standard_normal(f.shape).astype(np.float32)
                for f in layers_r]
    norms = [12.0, 14.0, 48.0, 250.0]
    gen = rng.standard_normal((2, 19, 4, 4, 3)).astype(np.float32)
    cases = {
        "sigmoid_crossentropy": (lambda m, a: m.sigmoid_crossentropy(a).sum(),
                                 [logits]),
        "adversarial_loss": (lambda m, a: m.adversarial_loss(a), [logits]),
        "discr_fake_loss": (lambda m, a: m.discr_fake_loss(a), [logits]),
        "discr_real_loss": (lambda m, a: m.discr_real_loss(a), [logits]),
        "ping_pong_loss": (lambda m, a: m.ping_pong_loss(a), [gen]),
        "vgg_cosine_loss": (lambda m, *a: m.vgg_cosine_loss(a[:2], a[2:]),
                            feats_r + feats_f),
        "feature_matching_loss": (
            lambda m, *a: m.feature_matching_loss(a[:4], a[4:], norms),
            layers_r + layers_f),
    }
    for name, (fn, args) in cases.items():
        want, j_g = jax.value_and_grad(
            lambda *a: fn(j_losses, *a), argnums=tuple(range(len(args))))(
            *[jnp.asarray(a) for a in args])
        t_args = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
        got = fn(losses, *t_args)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
        for t_a, g in zip(t_args, j_g):
            np.testing.assert_allclose(t_a.grad.numpy(), np.asarray(g),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
    assert losses.get_gan_loss_config({"adv_loss": 0.3}) == \
        j_losses.get_gan_loss_config({"adv_loss": 0.3})


def test_pingpong_group_channels_and_mask_bit_for_bit(rng):
    """The ping-pong order, the triple channel stacking and the border
    mask equal the reference's bit for bit."""
    x = rng.standard_normal((2, 10, 3, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(pingpong(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_pingpong(jnp.asarray(x))))
    y = rng.standard_normal((12, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _group_channels(torch.from_numpy(y)).numpy(),
        np.asarray(j_group_channels(jnp.asarray(y))))
    z = rng.standard_normal((4, 24, 32, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        _mask_border(torch.from_numpy(z), 6, 8).numpy(),
        np.asarray(j_mask_border(jnp.asarray(z), 6, 8)))


# ---------------------------------------------------------------------------
# The trainer

_Y_ATOL = 5e-5


def _check_forward(want, got):
    """Every returned tensor of ``GANTrainer.forward`` (lists element by
    element), within ``_Y_ATOL`` of the reference's relative to each
    tensor's largest value; the BN updates within 1e-5."""
    assert set(want) == set(got)
    for name, w in want.items():
        if name == "bn_updates":
            _check_updates(w, got[name])
            continue
        ws = w if isinstance(w, list) else [w]
        gs = got[name] if isinstance(got[name], list) else [got[name]]
        for g, wi in zip(gs, ws):
            wi = np.asarray(wi)
            assert g.shape == wi.shape, name
            scale = max(np.abs(wi).max(), 1.0)
            np.testing.assert_allclose(_np(g), wi, rtol=1e-4,
                                       atol=_Y_ATOL * scale, err_msg=name)


# The VGG loss is 1 - cos of near-parallel deep features (cos ~0.95 a
# layer): the features' 1e-5 relative differences give it an absolute
# one of ~1e-5, 5e-5 relative.
_TERM_RTOL = {"vgg_loss": 1e-4}


def _check_terms(want, got):
    for name, v in want.items():
        np.testing.assert_allclose(float(got[name]), float(v),
                                   rtol=_TERM_RTOL.get(name, LOSS_RTOL),
                                   atol=1e-7, err_msg=name)


def test_gan_forward_losses_and_gradients_match_reference(ref):
    """``GANTrainer.forward`` (every returned tensor), ``compute_losses``
    and both gradient pulls (the generator's loss by the generator
    group, the discriminator's by the discriminator) against the
    reference's ``jax.vjp`` with two cotangents, from the same params,
    u8 batch and draws; the s2d warp route (the GAN's default)."""
    (j_terms, j_y, j_gen, j_discr), (terms, y, gen, discr) = \
        _reference_all(ref)
    _check_forward(j_y, y)
    _check_terms(j_terms, terms)
    self_gen, self_discr = ref.cache["self"]
    _check_grads(j_gen, gen, max(GRAD_RTOL, 3 * self_gen))
    _check_grads(j_discr, discr, max(GRAD_RTOL, 3 * self_discr))
    assert any(k.startswith("gen.generator.block_1") for k in
               y["bn_updates"])


@pytest.mark.parametrize("variant", ["brightness", "pixel_warp"])
def test_gan_forward_variants_match_reference(ref, variant):
    """The forward and losses with ``normalize_brightness``, and on the
    pixel warp route (``s2d_train_warp`` false), under EMAs that close
    the generator's adversarial gate (``cond2`` 0) and open it (1)."""
    kw = ({"normalize_brightness": True} if variant == "brightness"
          else {"s2d_train_warp": False})
    j_tr = dataclasses.replace(ref.j.obj, **kw)
    t_tr = dataclasses.replace(ref.t.obj, **kw)
    jb = _j(ref.batch)
    emas = [(-0.1, -0.1), (0.5, -0.1)]

    def fwd(gp, dp, vp, inp, tgt, key):
        y = j_tr.forward(gp, dp, vp, inp, tgt, key, training=True)
        return y, [j_tr.compute_losses(y, {"t_balance1": jnp.float32(a),
                                           "t_balance2": jnp.float32(b)})
                   for a, b in emas]

    j_y, j_terms = jax.jit(fwd)(ref.jp["gen"], ref.jp["discr"],
                                ref.jp["vgg"], jb["input"], jb["target"],
                                ref.key)
    with torch.no_grad():
        y = t_tr.forward(ref.tp["gen"], ref.tp["discr"], ref.tp["vgg"],
                         *_t(ref.batch).values(), ref.noise)
    _check_forward(j_y, y)
    for (a, b), jt in zip(emas, j_terms):
        terms = t_tr.compute_losses(y, {"t_balance1": torch.tensor(a),
                                        "t_balance2": torch.tensor(b)})
        _check_terms(jt, terms)


# ---------------------------------------------------------------------------
# The step


def _j_state(ref, gopt, dopt, ema=None):
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
    gp, dp = copy(ref.jp["gen"]), copy(ref.jp["discr"])
    return JGANTrainState(gp, dp, gopt.init(gp), dopt.init(dp),
                          ema or ref.j.obj.init_ema(),
                          jnp.zeros((), jnp.int32))


def _reference_step(ref, gate_shut):
    """The reference's state after one step (its jitted step compiled
    once: the EMAs are inputs), with the gate open or forced shut."""
    name = f"step_{gate_shut}"
    if name not in ref.cache:
        gopt, dopt = j_make_optimizer(LR), j_make_optimizer(LR)
        if "j_step" not in ref.cache:
            ref.cache["j_step"] = j_build_gan_step(ref.j.obj, gopt, dopt,
                                                   ref.jp["vgg"])
        ema = ref.j.obj.init_ema()
        if gate_shut:
            ema = {**ema, "t_balance1": jnp.float32(1.0)}
        ref.cache[name] = ref.cache["j_step"](
            _j_state(ref, gopt, dopt, ema), _j(ref.batch), ref.key)
    return ref.cache[name]


def _port_state(ref, gate_shut=False):
    gopt, dopt = make_optimizer(LR), make_optimizer(LR)
    state = init_gan_state(ref.t.obj, ref.tp["gen"], ref.tp["discr"], gopt,
                           dopt, device="cpu")
    if gate_shut:
        state.ema["t_balance1"] = torch.tensor(1.0)
    step = build_gan_step(ref.t.obj, gopt, dopt, ref.tp["vgg"])
    return state, step


def _stats(flat):
    return {k: v for k, v in flat.items()
            if k.endswith(("moving_mean", "moving_variance", "counter"))}


def test_gan_step_matches_reference(ref):
    """One ``build_gan_step`` step against the reference's jitted step
    (lr 1e-3, gate open): the metrics; both groups' params after Adam
    (where the first gradient is above 1e-3 of its group's largest: a
    gradient near 0 that flips sign moves a param by 2 lr), Adam's
    moments (within the gradients' bounds, twice that for the squares)
    and counts, the EMAs, ``discr_steps``, and the moving statistics
    (the discriminator's are the real call's)."""
    j_state, j_metrics = _reference_step(ref, gate_shut=False)
    state, step = _port_state(ref)
    state, metrics = step(state, _t(ref.batch), noise=ref.noise)
    _check_terms(j_metrics, metrics)
    assert state.step == int(j_state.step) == 1
    assert state.ema["discr_steps"] == int(j_state.ema["discr_steps"]) == 1
    for k in ("t_balance1", "t_balance2"):
        np.testing.assert_allclose(float(state.ema[k]),
                                   float(j_state.ema[k]), rtol=1e-5,
                                   atol=1e-9)
    _, (_, _, gen_g, discr_g) = _reference_all(ref)
    bounds = [max(GRAD_RTOL, 3 * s) for s in ref.cache["self"]]
    for (group, grads), bound in zip((("gen", gen_g), ("discr", discr_g)),
                                     bounds):
        params = getattr(state, f"{group}_params")
        opt = getattr(state, f"{group}_opt_state")
        j_params = getattr(j_state, f"{group}_params")
        j_opt = getattr(j_state, f"{group}_opt_state")
        assert opt["count"] == int(j_opt[0].count) == 1
        got, want = to_flat_numpy(params), flatten_params(j_params)
        top = max(float(g.abs().max()) for g in grads.values())
        for path, g in to_flat_numpy(_nest(grads)).items():
            big = np.abs(g) > 1e-3 * top
            np.testing.assert_allclose(got[path][big], want[path][big],
                                       atol=1e-6, err_msg=path)
        for path, v in _stats(want).items():
            np.testing.assert_allclose(got[path], v, atol=STAT_ATOL,
                                       err_msg=path)
        for moment, j_m, k in (("mu", j_opt[0].mu, 1),
                               ("nu", j_opt[0].nu, 2)):
            got_m = to_flat_numpy(opt[moment])
            for path, v in flatten_params(j_m).items():
                assert _rel(got_m[path], v) <= k * bound, (moment, path)
    # The discriminator keeps the real call's statistics, as the
    # reference does: its updates come back through jax.vjp's aux with
    # sorted keys, so "discr.real.*" is merged last.
    _, (_, y, _, _) = _reference_all(ref)
    for call, close in (("real", True), ("fake", False)):
        upd = y["bn_updates"][f"discr.{call}.block_2.bn"]["moving_mean"]
        assert close == np.allclose(
            state.discr_params["block_2"]["bn"]["moving_mean"].numpy(),
            upd.numpy(), atol=STAT_ATOL, rtol=0), call


def test_gan_gate_shut_step_leaves_discriminator(ref):
    """With ``ema["t_balance1"]`` at 1.0 the gate stays shut: the
    discriminator's params and Adam state are unchanged bit for bit and
    its count stays 0, as the reference's; the generator trains and the
    discriminator's moving statistics still move (to the real call's)."""
    j_state, j_metrics = _reference_step(ref, gate_shut=True)
    state, step = _port_state(ref, gate_shut=True)
    before = to_flat_numpy(state.discr_params)
    state, metrics = step(state, _t(ref.batch), noise=ref.noise)
    assert int(j_state.ema["discr_steps"]) == state.ema["discr_steps"] == 0
    assert int(metrics["discr_steps"]) == 0
    assert state.discr_opt_state["count"] == int(
        j_state.discr_opt_state[0].count) == 0
    after = to_flat_numpy(state.discr_params)
    for path, v in before.items():
        if path.endswith(("moving_mean", "moving_variance")):
            np.testing.assert_allclose(
                after[path], flatten_params(j_state.discr_params)[path],
                atol=STAT_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(after[path], v, err_msg=path)
    for m in ("mu", "nu"):
        assert all(not np.any(v) for v in
                   to_flat_numpy(state.discr_opt_state[m]).values())
    assert state.gen_opt_state["count"] == 1
    np.testing.assert_allclose(float(metrics["t_balance1_avg"]),
                               float(j_state.ema["t_balance1"]), rtol=1e-5)


def test_gan_steps_per_execution_averages_losses_keeps_last_counts(ref):
    """K = 2: one execution on two stacked batches equals two single
    steps: the same params, and metrics that average the losses and keep
    the last ``discr_steps`` / EMA snapshots."""
    batches = [_batch(np.random.default_rng(s)) for s in (1, 2)]
    noises = [_j_noise(jax.random.PRNGKey(s)) for s in (1, 2)]
    gopt, dopt = make_optimizer(LR), make_optimizer(LR)
    a = init_gan_state(ref.t.obj, ref.tp["gen"], ref.tp["discr"], gopt, dopt,
                       device="cpu")
    single = build_gan_step(ref.t.obj, gopt, dopt, ref.tp["vgg"])
    per_step = [single(a, _t(b), noise=n)[1] for b, n in
                zip(batches, noises)]
    gopt2, dopt2 = make_optimizer(LR), make_optimizer(LR)
    b_state = init_gan_state(ref.t.obj, ref.tp["gen"], ref.tp["discr"],
                             gopt2, dopt2, device="cpu")
    double = build_gan_step(ref.t.obj, gopt2, dopt2, ref.tp["vgg"],
                            steps_per_execution=2)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    b_state, metrics = double(b_state, _t(stacked), noise=noises)
    assert b_state.step == a.step == 2
    for name, v in metrics.items():
        if name in ("discr_steps", "t_balance1_avg", "t_balance2_avg"):
            want = float(per_step[-1][name])
        else:
            want = float(np.mean([float(m[name]) for m in per_step]))
        np.testing.assert_allclose(float(v), want, rtol=1e-6, err_msg=name)
    for x, y in ((a.gen_params, b_state.gen_params),
                 (a.discr_params, b_state.discr_params)):
        for path, v in to_flat_numpy(x).items():
            np.testing.assert_array_equal(to_flat_numpy(y)[path], v)


def test_gan_checkpoints_cross_both_ways(ref, tmp_path):
    """The reference's GAN state after a step, saved by it, loads in the
    port (params, both Adam states, the EMAs with ``discr_steps`` int32,
    the step); the port saves the same keys and values, and the
    reference loads the port's file leaf for leaf."""
    j_state, _ = _reference_step(ref, gate_shut=False)
    j_path = str(tmp_path / "jax.npz")
    j_save_checkpoint(j_path, j_state.tree())
    state, _ = _port_state(ref)
    loaded = GANTrainState(**load_checkpoint(j_path, state.tree()))
    assert loaded.step == 1 and loaded.ema["discr_steps"] == 1
    assert loaded.gen_opt_state["count"] == loaded.discr_opt_state[
        "count"] == 1
    assert loaded.discr_params["conv_1"]["kernel"].requires_grad
    t_path = str(tmp_path / "torch.npz")
    save_checkpoint(t_path, loaded.tree())
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert b["ema.discr_steps"].dtype == np.int32
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = j_load_checkpoint(t_path, j_state.tree())
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(j_state.tree())):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# Registry and migration


def test_registry_builds_the_gan_config_on_both_sides():
    """``discriminator``, ``vgg`` and ``gan`` build with the reference's
    param keys and shapes (in the reference's layouts), VGG untrainable,
    the GAN's freezes relative to the generator group and the
    discriminator's in its config."""
    config = _config()
    config["flow"]["freeze"] = True
    config["discriminator"]["freeze"] = ["block_1"]
    j_models, models = _j_models(config), create_models(config)
    for name in config:
        assert models[name].kind == j_models[name].kind
        want = flatten_params(j_models[name].params)
        got = to_flat_numpy(models[name].params)
        assert list(got) == list(want), name
        assert all(got[k].shape == want[k].shape for k in want), name
    assert models["vgg"].trainable is j_models["vgg"].trainable is False
    gan, j_gan = models["gan"], j_models["gan"]
    assert gan.frozen_paths == j_gan.frozen_paths == ("flow",)
    for key in ("discr_trainable", "discr_frozen_paths", "learning_rate"):
        assert gan.config[key] == j_gan.config[key], key
    assert dict(gan.obj.loss_config) == dict(j_gan.obj.loss_config)


def test_copy_weights_and_copy_variables_equal_the_reference():
    """``copy_weights`` (leaves whose paths and shapes match) and
    ``copy_variables`` (LCS over (leaf name, shape), a generator grown
    from 1 to 2 res blocks) on the reference's trees give the
    reference's trees bit for bit, and the port's registry copies the
    same leaves from the same sources."""
    from joshupscale_torch.models.registry import _copy_matching
    from joshupscale_torch.utils.migrate import copy_model_variables

    base = _config()
    base["generator2"] = {"name": "generator-resnet", "num_filters": 8,
                          "num_res_blocks": 2}
    base["flow2"] = {"name": "flow-resnet", "num_inputs": 4,
                     "num_filters": 8, "num_res_blocks": 2}
    copied = json.loads(json.dumps(base))
    copied["generator2"]["copy_variables"] = "generator"
    copied["flow2"]["copy_weights"] = "flow"
    j_base, j_copied = _j_models(base), _j_models(copied)
    t_copied = create_models(copied)
    for dst, src, fn in (("generator2", "generator", copy_model_variables),
                         ("flow2", "flow", _copy_matching)):
        want = flatten_params(j_copied[dst].params)
        got = to_flat_numpy(fn(
            from_flat_numpy(flatten_params(j_base[dst].params)),
            from_flat_numpy(flatten_params(j_base[src].params))))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

        def pairs(models):
            d = to_flat_numpy(models[dst].params) if hasattr(
                models[dst].params["conv_1"]["kernel"], "detach") else \
                flatten_params(models[dst].params)
            s = to_flat_numpy(models[src].params) if hasattr(
                models[src].params["conv_1"]["kernel"], "detach") else \
                flatten_params(models[src].params)
            return {(p, q) for p, v in d.items() for q, w in s.items()
                    if v.shape == w.shape and v.size > 1
                    and np.array_equal(v, w)}

        assert pairs(t_copied) == pairs(j_copied) != set(), dst


# ---------------------------------------------------------------------------
# Play


def _play_setup():
    config = {k: v for k, v in _config(filters=32).items()
              if k in ("flow", "generator")}
    config["inference"] = {"name": "inference", "flow": {"model": "flow"},
                           "generator": {"model": "generator"},
                           "skip_processing": True, "frame_height": 16,
                           "frame_width": 16}
    j_inf = _j_models(config)["inference"]
    flat = _perturb(flatten_params(j_inf.params), seed=9)
    j_params = unflatten_into(j_inf.params,
                              {k: jnp.asarray(v) for k, v in flat.items()})
    t_inf = create_models(config)["inference"]
    b = _batch(np.random.default_rng(4), b=2, crop=CROP)
    return j_inf, j_params, t_inf, from_flat_numpy(flat), b


def test_play_prediction_and_strips_match_reference():
    """``predict_sequence`` (ping-pong playback through the serving form:
    prepared params, K1's plain version at C = 32) and ``build_strips``
    against the reference's on an 8x8 clip with the model
    re-dimensioned to it; float32 within 1e-4."""
    from joshupscale_tpu.training.play import (
        build_strips as j_build_strips,
        predict_sequence as j_predict_sequence,
    )
    from joshupscale_torch.training.play import (
        build_strips,
        predict_sequence,
    )

    j_inf, j_params, t_inf, t_params, b = _play_setup()
    jb = _j(b)
    j_model = dataclasses.replace(j_inf.obj, frame_height=CROP,
                                  frame_width=CROP)
    t_model = dataclasses.replace(t_inf.obj, frame_height=CROP,
                                  frame_width=CROP)
    # The reference's playback with its model step compiled once.
    step = jax.jit(lambda p, x, st: j_model.apply(p, x, st))
    proxy = types.SimpleNamespace(
        init_state=j_model.init_state,
        apply=lambda p, x, st, mut=None: step(p, x, st))
    want = j_predict_sequence(proxy, j_params, jb["input"], jb["target"])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()}
    got = predict_sequence(t_model, t_params, tb["input"], tb["target"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    j_strips = j_build_strips(want, jb["target"])
    strips = build_strips(got, tb["target"])
    for k in j_strips:
        np.testing.assert_allclose(strips[k], j_strips[k], atol=1e-4,
                                   err_msg=k)
    assert strips["comparison"].shape == (2, 18, 32, 96, 3)


def test_play_callback_writes_gifs(tmp_path):
    """``PlayCallback`` on u8 play clips (the model re-dimensioned from
    16x16 to the 8x8 clip): GIFs of 18 frames for the first clips at
    epochs on the interval, none between; the GAN state's generator
    group and a FRVSR state's params give the same prediction."""
    from PIL import Image

    from joshupscale_torch.training.play import PlayCallback

    _, _, t_inf, t_params, b = _play_setup()
    cb = PlayCallback(t_inf.obj, b, str(tmp_path), interval=2,
                      device="cpu")
    assert (cb.model.frame_height, cb.model.frame_width) == (CROP, CROP)
    gan_state = types.SimpleNamespace(gen_params=t_params)
    frvsr_state = types.SimpleNamespace(params=t_params)
    np.testing.assert_array_equal(cb.predict(gan_state)["comparison"],
                                  cb.predict(frvsr_state)["comparison"])
    cb(0, gan_state, {})
    cb(1, gan_state, {})
    files = sorted(os.listdir(tmp_path))
    assert files == ["play_e0000_0.gif", "play_e0000_1.gif"]
    with Image.open(tmp_path / files[0]) as gif:
        assert gif.n_frames == 18 and gif.size == (96, 32)


# ---------------------------------------------------------------------------
# The CLI


def test_training_cli_trains_a_gan_and_exports(tmp_path):
    """``training.cli.main`` on a tiny GAN config over generated PNG
    sequences (10-frame clips) on the CPU: two epochs with validation
    (monitor ``content_loss``), GIFs from the play callback, checkpoints
    that load into a ``GANTrainState`` (``discr_steps`` counted), the
    generator group exported as weights and as a package the reference's
    ``load_package`` opens; resume continues the step count."""
    import yaml

    from joshupscale_tpu.export.package import load_package as j_load
    from joshupscale_torch.training import cli
    from test_torch_data import _write_sequences

    _write_sequences(str(tmp_path / "train"), 1)
    _write_sequences(str(tmp_path / "val"), 1, seed=1)

    def chain(root):
        return [{"name": "LocalDatasetOp",
                 "lr_path": str(tmp_path / root / "lr" / "*.png"),
                 "hr_path": str(tmp_path / root / "hr" / "*.png")},
                {"name": "RandomCropOp", "crop_size": CROP, "num_img": 10}]

    models = _config(filters=32)
    models["inference"] = {"name": "inference", "flow": {"model": "flow"},
                           "generator": {"model": "generator"},
                           "skip_processing": True, "frame_height": CROP,
                           "frame_width": CROP}
    models["gan"]["inference"] = {"model": "inference"}
    config = {
        "models": models,
        "train_dataset": chain("train") + [{"name": "RepeatOp"}],
        "val_dataset": chain("val"),
        "train": {"model": "gan", "batch_size": 1, "epochs": 2,
                  "steps_per_epoch": 1, "val_size": 1, "play_size": 1,
                  "checkpoint_dir": str(tmp_path / "ckpt"),
                  "tensorboard": False},
        "export": {"dir": str(tmp_path / "export"), "model": "inference",
                   "overrides": {"frame_height": 12, "frame_width": 16}},
    }
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    assert cli.main(["-c", str(path), "--cpu"]) == 0

    ckpt = tmp_path / "ckpt"
    history = json.loads((ckpt / "history.json").read_text())
    assert len(history) == 2
    assert all(np.isfinite(e["val_content_loss"])
               and np.isfinite(e["train_gen_loss"]) for e in history)
    assert sorted(os.listdir(ckpt / "play")) == [
        "play_e0000_0.gif", "play_e0001_0.gif"]
    setup = cli.build_training(config, device="cpu")
    assert setup.monitor == "content_loss"
    restored = GANTrainState(**load_checkpoint(str(ckpt / "latest.npz"),
                                               setup.state.tree()))
    assert restored.step == 2
    assert restored.ema["discr_steps"] == history[-1]["train_discr_steps"]
    j_model, j_params = j_load(str(tmp_path / "export" / "package"))
    assert (j_model.frame_height, j_model.frame_width) == (12, 16)
    with np.load(tmp_path / "export" / "weights.npz") as w:
        np.testing.assert_array_equal(
            w["generator.conv_1.kernel"],
            to_flat_numpy(restored.gen_params)["generator.conv_1.kernel"])
        assert not any(k.startswith("discr") for k in w.files)
    config["train"].update(resume=str(ckpt / "latest.npz"), epochs=1,
                           checkpoint_dir=str(tmp_path / "ckpt2"))
    config["export"] = None
    assert cli.train(config, device="cpu") == 0
    resumed = load_checkpoint(str(tmp_path / "ckpt2" / "latest.npz"),
                              setup.state.tree())
    assert resumed["step"] == 3


def test_chip_smoke_gan_models_mirror_the_gan_config():
    """``chip_smoke.py``'s GAN phase trains the models section of
    ``configs/gan_synth_learn.yaml`` without its ``weights:`` lines (the
    checkpoints they name are not in the repository), at its trainer
    shape (batch 4, T = 10, LR crop 32, lr 5e-5)."""
    import importlib.util

    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(root, "configs", "gan_synth_learn.yaml")) as f:
        full = yaml.safe_load(f)
    want = full["models"]
    for entry in want.values():
        entry.pop("weights", None)
    assert json.loads(json.dumps(smoke.GAN_MODELS)) == want
    t = full["train"]
    assert (smoke.TRAIN_BATCH, smoke.TRAIN_T, smoke.TRAIN_CROP) == (
        t["batch_size"], 10, 32)
