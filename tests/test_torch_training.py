"""Port parity for FRVSR training (``joshupscale_torch.training``).

The JAX package is the oracle.  Small nets (8-16 filters, 1-2 res
blocks), batch 2, T = 4, LR crop 8; the reference's params are carried
across with ``flatten_params`` -> ``from_flat_numpy`` and gradients come
back through ``to_flat_numpy`` (the layouts are permutations, so
gradients map leaf for leaf).  Random inputs: the port's trainers take
their noise as tensors, and these tests feed the reference's own draws
(the same ``jax.random`` calls on the same split keys).  Batches are u8
with saturated pixels: 0 and 255 normalize to exactly -0.5 and 0.5, the
bounds of the generator's clip, and zero-initialized heads put every
warp weight at exactly 0, the bound of the warp's clip.

The reference runs jitted on float batches that numpy normalized
(``x / 255 - 0.5``, exact: 255 gives 0.5), the port on the u8 batches,
which it normalizes the same way.  A jitted reference given u8 computes
the normalization as one FMA with the float32 reciprocal of 255, which
makes 255 into 0.50000006, off the clip's bound, and moves the last
deconv's gradient by up to 1%.

Bounds (float32 on both sides; the sums run in other orders): losses
within 2e-5 relative, each gradient within 1e-4 relative L2 error,
moving statistics within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from joshupscale_tpu.export.importer import flatten_params
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.nn.layers import batch_norm as j_batch_norm
from joshupscale_tpu.ops.warp import (
    dense_image_warp as j_warp,
    dense_image_warp_via_s2d as j_warp_via_s2d,
)
from joshupscale_tpu.training import (
    build_frvsr_step as j_build_step,
    init_train_state as j_init_state,
    load_checkpoint as j_load_checkpoint,
    make_optimizer as j_make_optimizer,
    save_checkpoint as j_save_checkpoint,
)
from joshupscale_tpu.training.schedules import (
    get_learning_rate as j_learning_rate,
)
from joshupscale_torch.export.weights import from_flat_numpy, to_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.nn.layers import batch_norm_train
from joshupscale_torch.ops.image import clip
from joshupscale_torch.ops.warp import (
    dense_image_warp,
    dense_image_warp_via_s2d,
)
from joshupscale_torch.training import (
    TrainState,
    build_frvsr_step,
    freeze_mask,
    init_train_state,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)
from joshupscale_torch.training.schedules import get_learning_rate
from joshupscale_torch.training.trainer import _trainable_copy, loss_and_grads

B, T, CROP = 2, 4, 8
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-4
STAT_ATOL = 1e-5


def _config(filters=8, blocks=1, zero_init_tail=True, fade_in=0, **frvsr):
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": filters, "num_res_blocks": blocks,
                 "zero_init_tail": zero_init_tail},
        "generator": {"name": "generator-resnet", "num_filters": filters,
                      "num_res_blocks": blocks,
                      "num_fade_in_res_blocks": fade_in,
                      "fade_in_period": 3,
                      "zero_init_tail": zero_init_tail},
        "frvsr": {"name": "frvsr", "flow": {"model": "flow"},
                  "generator": {"model": "generator"}, **frvsr},
    }


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


def _j_noise(key, b=B, t=T, crop=CROP, num_flow_frames=4):
    """The reference's draws for ``key`` (``FRVSRTrainer.forward``)."""
    k_hist, k_first = jax.random.split(key)
    noise = {"first_warp": jax.random.uniform(
        k_first, (b, 4 * crop, 4 * crop, 3), jnp.float32, -0.5, 0.5)}
    if num_flow_frames > 2:
        noise["history"] = jax.random.uniform(
            k_hist, (b, num_flow_frames - 2, crop, crop, 3), jnp.float32,
            -0.5, 0.5)
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    """The reference's batch: u8 arrays normalized by numpy, exactly."""
    return {k: jnp.asarray(v.astype(np.float32) / np.float32(255)
                           - np.float32(0.5)) for k, v in batch.items()}


def _pair(config, name="frvsr"):
    """The reference's built trainer entry and the port's, with the
    reference's params carried across."""
    j_built = j_create_models(config)[name]
    t_built = create_models(config)[name]
    t_built.params = from_flat_numpy(flatten_params(j_built.params))
    return j_built, t_built


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_grads(j_grads, t_grads):
    """Every trainable leaf's gradient within ``GRAD_RTOL`` (relative L2)
    of the reference's; the reference's other leaves get zeros."""
    got = to_flat_numpy(_nest(t_grads))
    want = flatten_params(j_grads)
    for path, ref in want.items():
        if path not in got:
            assert not np.any(ref), path
            continue
        assert _rel(got[path], ref) <= GRAD_RTOL, (path, _rel(got[path],
                                                               ref))
    assert set(got) <= set(want)


def _check_updates(j_updates, t_updates):
    assert set(j_updates) == set(t_updates)
    for path, stats in j_updates.items():
        for stat, v in stats.items():
            np.testing.assert_allclose(
                t_updates[path][stat].numpy(), np.asarray(v),
                atol=STAT_ATOL, err_msg=f"{path}.{stat}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_train_matches_reference(rng, dtype):
    """Batch statistics in float32, population variance, the output in
    the input's dtype, one momentum step of the moving statistics."""
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32) * 2 + 0.3
    params = {"gamma": rng.random(6).astype(np.float32) + 0.5,
              "beta": rng.standard_normal(6).astype(np.float32),
              "moving_mean": rng.standard_normal(6).astype(np.float32),
              "moving_variance": rng.random(6).astype(np.float32) + 1}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want, want_stats = j_batch_norm(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jdt), training=True)
    got, got_stats = batch_norm_train(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * 4, rtol=tol)
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7)


def test_clip_passes_the_reference_gradient_at_its_bounds():
    """``jnp.clip``'s gradient is 0.5 at a bound; ``clip`` matches it."""
    x = np.array([-0.5, 0.5, 0.0, 0.7, -0.9], np.float32)
    want = jax.grad(lambda v: jnp.clip(v, -0.5, 0.5).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    clip(t, -0.5, 0.5).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        clip(torch.from_numpy(x), -0.5, 0.5).numpy(), np.clip(x, -0.5, 0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("via_s2d", [False, True],
                         ids=["pixel", "via_s2d"])
def test_warp_values_and_gradients_match_reference(rng, dtype, via_s2d):
    """Both training warps, forward and gradients in the image and the
    flow, against the reference's: flows that leave the frame (the
    edge clamp), integer flows (weights at exactly 0, the clip's bound)
    and fractional ones.  The s2d form's image gradient is summed in
    float32 (``_SegsumGather``) as the reference's custom VJP sums it.
    Bounds: float32 to round-off; bf16 within a few bf16 steps of the
    reference (a product may round the other way)."""
    n, h, w, c = 2, 12, 16, 3
    image = rng.standard_normal((n, h, w, c)).astype(np.float32) * 0.3
    flow = (rng.standard_normal((n, h, w, 2)) * 3).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4])  # integer flows: alpha == 0
    flow[1, -2:] = 40.0  # far outside the frame
    cot = rng.standard_normal((n, h, w, c)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j_fn = j_warp_via_s2d if via_s2d else j_warp
    t_fn = dense_image_warp_via_s2d if via_s2d else dense_image_warp

    def j_loss(img, fl):
        out = j_fn(img.astype(jdt), fl.astype(jdt))
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (g_img, g_flow) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(image),
                                               jnp.asarray(flow))
    t_img = torch.from_numpy(image).requires_grad_()
    t_flow = torch.from_numpy(flow).requires_grad_()
    out = t_fn(t_img.to(dtype), t_flow.to(dtype))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for got, ref in ((t_img.grad, g_img), (t_flow.grad, g_flow)):
        ref = np.asarray(ref)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5,
                                       rtol=1e-5)
        else:
            assert _rel(got.numpy(), ref) < 0.02


_LOSS_CASES = {
    "zero_init_remat": ({}, True),
    "random_init_no_remat": ({"zero_init_tail": False}, False),
    "brightness": ({"normalize_brightness": True}, True),
    "s2d_supervision_warp": ({"s2d_train_warp": True}, True),
    # A fade-in block: its counter advances once per generator call.
    "fade_in": ({"zero_init_tail": False, "fade_in": 1}, True),
}


@pytest.mark.parametrize("case", list(_LOSS_CASES))
def test_frvsr_loss_and_gradients_match_reference(rng, case):
    """``FRVSRTrainer.loss``, every gradient (``jax.value_and_grad``) and
    the collected BN updates (the generator's averaged over the
    recurrence, overwriting the first frame's) against the reference,
    from the same params, u8 batch (saturated pixels) and draws."""
    kw, remat = _LOSS_CASES[case]
    config = _config(**{k: v for k, v in kw.items()
                        if k in ("zero_init_tail", "fade_in")},
                     **{k: v for k, v in kw.items()
                        if k in ("normalize_brightness", "s2d_train_warp")})
    j_built, t_built = _pair(config)
    batch = _batch(rng)
    key = jax.random.PRNGKey(3)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        j_built.obj.loss, has_aux=True))(j_built.params, _j(batch), key)
    trainer = t_built.obj
    if not remat:
        import dataclasses

        trainer = dataclasses.replace(trainer, remat=False)
    loss, aux, grads = loss_and_grads(trainer, _trainable_copy(
        t_built.params), _t(batch), _j_noise(key))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    for name, v in j_aux["metrics"].items():
        np.testing.assert_allclose(float(aux["metrics"][name]), float(v),
                                   rtol=LOSS_RTOL)
    _check_grads(j_grads, grads)
    _check_updates(j_aux["bn_updates"], aux["bn_updates"])
    assert any(k.startswith("generator.block_1") for k in aux["bn_updates"])


def test_frvsr_forward_outputs_match_reference(rng):
    """The recurrence's outputs and the supervision warp themselves."""
    j_built, t_built = _pair(_config(zero_init_tail=False))
    batch = _batch(rng)
    key = jax.random.PRNGKey(5)
    jb = _j(batch)
    want = jax.jit(j_built.obj.forward)(j_built.params, jb["input"],
                                        jb["target"], key)
    with torch.no_grad():
        got = t_built.obj.forward(t_built.params,
                                  torch.from_numpy(batch["input"]),
                                  torch.from_numpy(batch["target"]),
                                  _j_noise(key))
    for name in ("gen_outputs", "target_warp", "gen_warp", "flow"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=2e-5, rtol=1e-5, err_msg=name)


def test_frvsr_single_trainer_matches_reference(rng):
    """``frvsr-single`` (one step through the inference model's training
    form, its pixel-state twin): loss, gradients, updates, and the
    validation loss (inference batch norm)."""
    config = {
        "flow": {"name": "flow-resnet", "num_inputs": 4,
                 "num_filters": 8, "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 8,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": True, "frame_height": CROP,
                      "frame_width": CROP, "normalize_brightness": True},
        "single": {"name": "frvsr-single",
                   "inference": {"model": "inference"}},
    }
    j_built, t_built = _pair(config, "single")
    window = rng.integers(0, 256, (B, 4, CROP, CROP, 3), dtype=np.uint8)
    window[:, :, 0] = 255
    batch = {"input": window,
             "target": rng.integers(0, 256, (B, 4 * CROP, 4 * CROP, 3),
                                    dtype=np.uint8),
             "last": rng.integers(0, 256, (B, 4 * CROP, 4 * CROP, 3),
                                  dtype=np.uint8)}
    j_batch = _j(batch)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        j_built.obj.loss, has_aux=True))(j_built.params, j_batch)
    loss, aux, grads = loss_and_grads(
        t_built.obj, _trainable_copy(t_built.params), _t(batch), {})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    _check_grads(j_grads, grads)
    _check_updates(j_aux["bn_updates"], aux["bn_updates"])
    j_val, _ = j_built.obj.loss(j_built.params, j_batch, training=False)
    with torch.no_grad():
        val, _ = t_built.obj.loss(t_built.params, _t(batch),
                                  training=False)
    np.testing.assert_allclose(float(val), float(j_val), rtol=LOSS_RTOL)


_SCHEDULES = [
    0.001,
    {"name": "constant", "value": 0.002},
    {"name": "exponential", "initial_learning_rate": 0.01,
     "decay_steps": 3, "decay_rate": 0.5, "staircase": True},
    {"name": "exponential", "initial_learning_rate": 0.01,
     "decay_steps": 3, "decay_rate": 0.5},
    {"name": "piecewise", "boundaries": [2, 5], "values": [0.1, 0.01, 0.001]},
]


@pytest.mark.parametrize("lr", _SCHEDULES,
                         ids=["float", "constant", "staircase", "smooth",
                              "piecewise"])
def test_schedules_match_optax_step_by_step(lr):
    """Across the staircase's steps and the Keras-inclusive boundaries."""
    want = j_learning_rate(lr)
    got = get_learning_rate(lr)
    for step in range(9):
        w = want(step) if callable(want) else want
        g = got(step) if callable(got) else got
        np.testing.assert_allclose(g, float(w), rtol=1e-6, err_msg=step)


@pytest.mark.parametrize("lr", [1e-3, _SCHEDULES[4]],
                         ids=["float", "piecewise"])
def test_adam_matches_optax_on_identical_gradients(rng, lr):
    """Four steps of the port's Adam and ``optax.adam`` (b1 0.9, b2
    0.999, eps 1e-7, bias correction, eps outside the root) on the same
    gradients; the moving statistics take no step.  Params within 2
    float32 ulps of their size, moments within round-off."""
    shapes = {"conv": {"kernel": (4, 3), "bias": (4,)},
              "bn": {"gamma": (4,), "beta": (4,), "moving_mean": (4,),
                     "moving_variance": (4,)}}
    init = {m: {k: rng.standard_normal(s).astype(np.float32)
                for k, s in leaves.items()} for m, leaves in shapes.items()}
    j_opt = j_make_optimizer(lr)
    j_params = jax.tree_util.tree_map(jnp.asarray, init)
    j_state = j_opt.init(j_params)
    opt = make_optimizer(lr)
    params = _trainable_copy({m: {k: torch.from_numpy(v.copy())
                                  for k, v in d.items()}
                              for m, d in init.items()})
    state = opt.init(params)
    for _ in range(4):
        grads = {m: {k: (rng.standard_normal(v.shape) * 0.1).astype(
            np.float32) if not k.startswith("moving") else
            np.zeros_like(v) for k, v in d.items()} for m, d in init.items()}
        upd, j_state = j_opt.update(jax.tree_util.tree_map(
            jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        opt.update(params, {f"{m}.{k}": torch.from_numpy(v)
                            for m, d in grads.items() for k, v in d.items()
                            if not k.startswith("moving")}, state)
    for m, d in params.items():
        for k, v in d.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(j_params[m][k]),
                                       rtol=3e-7, atol=1e-7)
    np.testing.assert_allclose(state["mu"]["conv"]["kernel"].numpy(),
                               np.asarray(j_state[0].mu["conv"]["kernel"]),
                               rtol=1e-6)
    assert state["count"] == int(j_state[0].count) == 4


def _j_step_state(j_built, opt):
    return j_init_state(j_built.params, opt)


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "steps_per_execution2"])
def test_three_train_steps_match_reference_step(rng, k):
    """Three optimizer steps of ``build_frvsr_step`` against the
    reference's jitted step (``steps_per_execution`` 2: executions of
    two steps on stacked batches, the noise of the reference's
    ``fold_in(rng, step)`` keys): the losses, the moving statistics
    after the steps, and every param whose first gradient is above
    1e-3 of the largest (a gradient near 0 that flips sign moves a
    param by 2 lr under Adam), within 1% of one Adam step (lr 1e-3).
    The losses within 1e-4 relative (three steps of Adam apart)."""
    config = _config(zero_init_tail=False)
    j_built, t_built = _pair(config)
    j_opt, opt = j_make_optimizer(1e-3), make_optimizer(1e-3)
    j_step = j_build_step(j_built.obj, j_opt, steps_per_execution=k)
    step = build_frvsr_step(t_built.obj, opt, steps_per_execution=k)
    j_state = _j_step_state(j_built, j_opt)
    state = init_train_state(t_built.params, opt, device="cpu")
    batches = [_batch(rng) for _ in range(3 if k == 1 else 4)]
    first_grads = None
    for i in range(3 if k == 1 else 2):
        key = jax.random.PRNGKey(10 + i)
        if k == 1:
            batch, noise = batches[i], _j_noise(key)
            if first_grads is None:
                _, _, first_grads = loss_and_grads(
                    t_built.obj, state.params, _t(batch), noise)
        else:
            group = batches[2 * i:2 * i + 2]
            batch = {n: np.stack([g[n] for g in group]) for n in group[0]}
            noise = [_j_noise(jax.random.fold_in(key, state.step + s))
                     for s in range(k)]
        j_state, j_metrics = j_step(j_state, _j(batch), key)
        state, metrics = step(state, _t(batch), noise=noise)
        for name, v in j_metrics.items():
            np.testing.assert_allclose(float(metrics[name]), float(v),
                                       rtol=1e-4, err_msg=f"{i} {name}")
    assert state.step == int(j_state.step) == (3 if k == 1 else 4)
    got = to_flat_numpy(state.params)
    want = flatten_params(j_state.params)
    for path, ref in want.items():
        if path.endswith(("moving_mean", "moving_variance")):
            np.testing.assert_allclose(got[path], ref, atol=STAT_ATOL,
                                       err_msg=path)
    if first_grads is not None:
        top = max(float(g.abs().max()) for g in first_grads.values())
        flat_g = to_flat_numpy(_nest(first_grads))
        for path, g in flat_g.items():
            big = np.abs(g) > 1e-3 * top
            np.testing.assert_allclose(got[path][big], want[path][big],
                                       atol=1e-5, err_msg=path)


def test_freeze_mask_keeps_frozen_params():
    """``freeze_mask`` as the reference builds it, and a masked step
    moves no frozen leaf while the others train."""
    from joshupscale_tpu.training import freeze_mask as j_freeze_mask

    config = _config(zero_init_tail=False)
    config["flow"]["freeze"] = True
    j_built, t_built = _pair(config)
    assert t_built.frozen_paths == j_built.frozen_paths == ("flow",)
    mask = freeze_mask(t_built.params, t_built.frozen_paths)
    want = flatten_params(j_freeze_mask(j_built.params,
                                        j_built.frozen_paths))
    assert {k: float(v) for k, v in want.items()} == _flat(mask)
    assert all(v == 0.0 for v in _flat(freeze_mask(
        t_built.params, (), trainable=False)).values())
    opt = make_optimizer(1e-2)
    state = init_train_state(t_built.params, opt, device="cpu")
    before = to_flat_numpy(state.params)
    step = build_frvsr_step(t_built.obj, opt, mask=mask)
    state, _ = step(state, _t(_batch(np.random.default_rng(1))),
                    rng=torch.Generator().manual_seed(0))
    after = to_flat_numpy(state.params)
    for path, v in before.items():
        if path.startswith("flow.") and "moving" not in path:
            np.testing.assert_array_equal(after[path], v, err_msg=path)
    assert not np.array_equal(after["generator.conv_1.kernel"],
                              before["generator.conv_1.kernel"])


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}.{k}" if path else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("lr", [1e-3, _SCHEDULES[4]],
                         ids=["float", "piecewise"])
def test_checkpoints_cross_both_ways(rng, tmp_path, lr):
    """A state after a step, written by each package, loads in the other
    leaf for leaf (params, Adam's count and moments, the schedule's
    count, the step), and the resumed port state trains on."""
    config = _config(zero_init_tail=False)
    j_built, t_built = _pair(config)
    j_opt, opt = j_make_optimizer(lr), make_optimizer(lr)
    j_state = _j_step_state(j_built, j_opt)
    j_state, _ = j_build_step(j_built.obj, j_opt)(
        j_state, {k: jnp.asarray(v) for k, v in _batch(rng).items()},
        jax.random.PRNGKey(0))
    j_path = str(tmp_path / "jax.npz")
    j_save_checkpoint(j_path, j_state.tree())

    state = init_train_state(t_built.params, opt, device="cpu")
    loaded = TrainState(**load_checkpoint(j_path, state.tree()))
    assert loaded.step == 1 and loaded.opt_state["count"] == 1
    t_path = str(tmp_path / "torch.npz")
    save_checkpoint(t_path, loaded.tree())
    with np.load(j_path) as a, np.load(t_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = j_load_checkpoint(t_path, j_state.tree())
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(j_state.tree())):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert loaded.params["generator"]["conv_1"]["kernel"].requires_grad
    step = build_frvsr_step(t_built.obj, opt)
    loaded, metrics = step(loaded, _t(_batch(rng)),
                           rng=torch.Generator().manual_seed(1))
    assert loaded.step == 2 and np.isfinite(float(metrics["loss"]))
    with pytest.raises(NotImplementedError):
        save_checkpoint(str(tmp_path / "orbax_dir"), loaded.tree())


def test_registry_builds_frvsr_trainers_and_refuses_the_gan():
    """``frvsr`` and ``frvsr-single`` build; the GAN slice's model types
    are refused by name."""
    models = create_models(_config())
    assert models["frvsr"].kind == "frvsr"
    config = _config()
    config["gan"] = {"name": "gan", "flow": {"model": "flow"}}
    with pytest.raises(NotImplementedError, match="ROADMAP 14b"):
        create_models(config)


def test_chip_smoke_training_models_mirror_the_quality_config():
    """``chip_smoke.py`` trains the models section of
    ``configs/frvsr_quality.yaml`` with ``zero_init_tail`` as
    ``configs/frvsr_synth.yaml`` sets it."""
    import importlib.util

    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(root, "configs", "frvsr_quality.yaml")) as f:
        quality = yaml.safe_load(f)["models"]
    with open(os.path.join(root, "configs", "frvsr_synth.yaml")) as f:
        synth = yaml.safe_load(f)["models"]
    got = json.loads(json.dumps(smoke.TRAIN_MODELS))
    for name, entry in got.items():
        assert entry.pop("zero_init_tail", None) == synth[name].get(
            "zero_init_tail"), name
    assert got == quality
    assert (smoke.TRAIN_BATCH, smoke.TRAIN_T, smoke.TRAIN_CROP) == (4, 10, 32)
