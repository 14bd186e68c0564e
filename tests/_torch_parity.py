"""Helpers of the port's parity tests: one config built on both packages,
the reference's params (BN stats perturbed) carried across with
``flatten_params`` -> ``from_flat_numpy``, and u8 frame comparison."""

import numpy as np

from joshupscale_tpu.export.importer import flatten_params, unflatten_into
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.runtime.engine import Engine as JEngine
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.runtime.engine import Engine


def flat_params(config, seed=0):
    """The reference's built inference entry and its params (moving
    stats perturbed, so batch norm is no identity) as the flat numpy
    dict."""
    built = j_create_models(config, seed=seed)["inference"]
    rng = np.random.default_rng(seed + 100)
    flat = flatten_params(built.params)
    for k, v in flat.items():
        if k.endswith("moving_mean"):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        elif k.endswith("moving_variance"):
            flat[k] = (1 + rng.random(v.shape)).astype(np.float32)
    return built, flat


def sub_params(flat, prefix, template):
    """The reference's params of one net (``prefix`` "flow" or
    "generator") as a JAX param tree shaped like ``template``."""
    import jax.numpy as jnp

    dot = prefix + "."
    return unflatten_into(template, {k[len(dot):]: jnp.asarray(v)
                                     for k, v in flat.items()
                                     if k.startswith(dot)})


def engine_factory(config, seed=0):
    """A function making fresh (reference engine, port engine on the
    CPU) pairs with the same params; its keyword arguments go to the
    port's ``Engine``.  The pairs share their models, so the reference
    compiles its step once."""
    built, flat = flat_params(config, seed)
    j_params = unflatten_into(built.params, flat)
    t_model = create_models(config, seed=seed)["inference"].obj
    t_params = from_flat_numpy(flat)
    return lambda **kw: (JEngine(built.obj, j_params),
                         Engine(t_model, t_params, device="cpu", **kw))


def engines(config, seed=0):
    """(reference engine, port engine on the CPU) with the same params."""
    return engine_factory(config, seed)()


def u8_frames(rng, t, h, w):
    return rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)


def u8_diff(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    return np.abs(got.astype(np.int32) - ref.astype(np.int32))
