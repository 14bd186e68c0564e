"""Port parity for the single-card tail: the display helpers, ``fit``'s
profiler window and the public names the port lacked, each held against
the reference's own call on the CPU."""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat_params
from joshupscale_tpu.export import importer as j_importer
from joshupscale_tpu.models import common as j_common
from joshupscale_tpu.models import registry as j_registry
from joshupscale_tpu.nn import layers as j_layers
from joshupscale_tpu.ops.resize import resize_nearest as j_resize_nearest
from joshupscale_tpu.training import trainer as j_trainer
from joshupscale_tpu.utils import display as j_display
from joshupscale_torch.export import importer
from joshupscale_torch.export.weights import from_flat_numpy, to_flat_numpy
from joshupscale_torch.models import common, registry
from joshupscale_torch.nn import layers
from joshupscale_torch.ops import resize_nearest
from joshupscale_torch.training import trainer
from joshupscale_torch.utils import display

CONFIG = {
    "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
             "num_res_blocks": 1},
    "generator": {"name": "generator-resnet", "num_filters": 32,
                  "num_res_blocks": 1, "num_fade_in_res_blocks": 1,
                  "fade_in_period": 4},
    "inference": {"name": "inference", "flow": {"model": "flow"},
                  "generator": {"model": "generator"},
                  "skip_processing": False, "frame_height": 6,
                  "frame_width": 10},
}


def _same_flat(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# utils/display.py


def test_to_display_equals_reference(rng):
    u8 = rng.integers(0, 256, (5, 7, 3), np.uint8)
    norm = rng.uniform(-0.7, 0.7, (2, 5, 7, 3)).astype(np.float32)
    gray = rng.uniform(-0.5, 0.5, (5, 7)).astype(np.float64)
    for img in (u8, norm, gray):
        for bgr in (True, False):
            got, want = display.to_display(img, bgr), j_display.to_display(
                img, bgr)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", ["paired", "window", "batched", "compare"])
def test_display_figures_match_reference_size(rng, tmp_path, form):
    """The saved figure exists and has the reference's pixel size, for
    each element form of ``display_data`` and for
    ``display_comparison``."""
    import cv2

    def norm(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    if form == "compare":
        args = (rng.integers(0, 256, (8, 8, 3), np.uint8),
                rng.integers(0, 256, (32, 32, 3), np.uint8),
                rng.integers(0, 256, (32, 32, 3), np.uint8))
        call = lambda mod, path: mod.display_comparison(  # noqa: E731
            *args, save_path=path)
    else:
        if form == "paired":
            elems = [{"input": norm(3, 4, 4, 3), "target": norm(3, 16, 16, 3)}
                     for _ in range(2)]
        elif form == "window":
            elems = [{"input": norm(1, 4, 4, 3), "last": norm(16, 16, 3),
                      "target": norm(16, 16, 3)}]
        else:
            elems = [{"input": norm(2, 3, 4, 4, 3),
                      "target": norm(2, 3, 16, 16, 3)}]
        call = lambda mod, path: mod.display_data(  # noqa: E731
            iter(elems), num_img=2, save_path=path)
    sizes = []
    for mod, name in ((display, "port.png"), (j_display, "ref.png")):
        path = str(tmp_path / name)
        call(mod, path)
        assert os.path.getsize(path) > 0
        sizes.append(cv2.imread(path).shape)
    assert sizes[0] == sizes[1]
    with pytest.raises(ValueError, match="no elements"):
        display.display_data(iter([]), 1, save_path=str(tmp_path / "x.png"))


def test_display_module_imports_no_matplotlib():
    """matplotlib is imported only when a figure is drawn."""
    import subprocess

    code = ("import sys; import joshupscale_torch.utils.display; "
            "assert 'matplotlib' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


# ---------------------------------------------------------------------------
# Public names


@pytest.mark.parametrize("size", [(4, 6), (8, 12), (5, 9), (3, 4), (12, 24)])
def test_resize_nearest_equals_reference(rng, size):
    x = rng.standard_normal((2, 4, 6, 3)).astype(np.float32)
    got = resize_nearest(torch.from_numpy(x), *size).numpy()
    want = np.asarray(j_resize_nearest(jnp.asarray(x), *size))
    assert got.shape == want.shape == (2, *size, 3)
    np.testing.assert_array_equal(got, want)


def test_registry_names_match_reference(monkeypatch):
    """``register_model`` adds a factory to both registries' tables;
    ``strip_meta`` drops ``_meta`` in dicts and lists; ``num_params``
    and ``strip_meta`` of a built model count and keep what the
    reference's do."""
    tree = {"a": {"_meta": {"k": 1}, "w": np.ones(3)},
            "b": [{"_meta": 2, "v": np.zeros(2)}, np.ones(1)], "_meta": 0}
    got, want = registry.strip_meta(tree), j_registry.strip_meta(tree)
    assert list(got) == list(want) == ["a", "b"]
    assert list(got["a"]) == list(want["a"]) == ["w"]
    assert list(got["b"][0]) == list(want["b"][0]) == ["v"]

    j_built = j_registry.create_models(CONFIG, seed=0)
    built = registry.create_models(CONFIG, seed=0)
    for name in CONFIG:
        assert built[name].num_params() == j_built[name].num_params()
        assert sorted(to_flat_numpy(built[name].strip_meta())) == sorted(
            j_importer.flatten_params(j_built[name].strip_meta()))

    calls = []

    def factory(mod):
        def build(rng, **kw):
            calls.append(kw)
            return mod.BuiltModel(kind="tiny", params={"w": np.zeros(4)})
        return build

    monkeypatch.setitem(registry.MODELS, "tiny", None)
    monkeypatch.setitem(j_registry.MODELS, "tiny", None)
    registry.register_model("tiny", factory(registry))
    j_registry.register_model("tiny", factory(j_registry))
    cfg = {"t": {"name": "tiny", "width": 3}}
    assert registry.create_models(cfg)["t"].kind == "tiny"
    assert j_registry.create_models(cfg)["t"].kind == "tiny"
    assert calls == [{"width": 3}, {"width": 3}]
    assert registry.create_models(cfg)["t"].num_params() == 4


def test_inference_out_size_matches_reference():
    j_model = j_registry.create_models(CONFIG)["inference"].obj
    model = registry.create_models(CONFIG)["inference"].obj
    assert model.out_height() == j_model.out_height() == 24
    assert model.out_width() == j_model.out_width() == 40


def test_apply_mask_matches_reference(rng):
    """Gradients times the freeze mask, against the reference's
    ``apply_mask`` on the same mask."""
    params = {"flow": {"conv_1": {"kernel": np.zeros((2, 3))}},
              "generator": {"conv_1": {"kernel": np.zeros((4,)),
                                       "bias": np.zeros((2,))}}}
    frozen = ("generator.conv_1.bias",)
    mask = trainer.freeze_mask(params, frozen)
    j_mask = j_trainer.freeze_mask(params, frozen)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    want = j_trainer.apply_mask(jax.tree_util.tree_map(jnp.asarray, grads),
                                j_mask)
    got = trainer.apply_mask(jax.tree_util.tree_map(torch.from_numpy, grads),
                             mask)
    _same_flat(importer.flatten_params(got), j_importer.flatten_params(want))
    assert float(got["generator"]["conv_1"]["bias"].abs().max()) == 0.0


def test_tensorboard_histograms(tmp_path, monkeypatch):
    """One histogram per weight, tagged with the reference's dotted
    paths; a no-op without the ``tensorboard`` package."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    built, flat = flat_params(CONFIG)
    params = from_flat_numpy(flat)
    logger = trainer.TensorBoardLogger(str(tmp_path / "tb"))
    logger.histograms(params, step=3)
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = acc.Tags()["histograms"]
    assert sorted(tags) == sorted(j_importer.flatten_params(built.params))
    kernel = "generator.conv_1.kernel"
    event = acc.Histograms(kernel)[0]
    assert event.step == 3 and event.histogram_value.num == flat[kernel].size

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    quiet = trainer.TensorBoardLogger(str(tmp_path / "none"))
    quiet.histograms(params, step=0)
    quiet.scalars({"loss": 1.0}, step=0)
    assert not os.path.exists(tmp_path / "none")


def test_deconv_init_and_activations_match_reference(rng):
    """``conv2d_transpose_2x_init``: the reference's kernel shape (in the
    port's product layout), glorot limits and bias; the generator's
    deconvs come from it.  ``ACTIVATIONS``: the reference's keys and
    factories, applied to the same values."""
    got = layers.conv2d_transpose_2x_init(np.random.default_rng(0), 8, 3)
    want = j_layers.conv2d_transpose_2x_init(jax.random.PRNGKey(0), 8, 3)
    exported = to_flat_numpy({"conv_trans_1": got})
    assert exported["conv_trans_1.kernel"].shape == want["kernel"].shape
    assert got["kernel"].shape == (8, 12)
    limit = (6.0 / (4 * 8 + 4 * 3)) ** 0.5
    assert float(got["kernel"].abs().max()) <= limit
    assert float(np.abs(np.asarray(want["kernel"])).max()) <= limit
    np.testing.assert_array_equal(got["bias"].numpy(), want["bias"])
    assert "bias" not in layers.conv2d_transpose_2x_init(
        np.random.default_rng(0), 8, 3, use_bias=False)
    gen = registry.create_models({"g": CONFIG["generator"]}, seed=2)["g"]
    again = layers.conv2d_transpose_2x_init(
        np.random.default_rng([2, 0]), 8, 3)
    assert gen.params["conv_trans_1"]["kernel"].shape == (32, 128)
    assert again["kernel"].shape == (8, 12)

    assert sorted(layers.ACTIVATIONS) == sorted(j_layers.ACTIVATIONS)
    x = rng.standard_normal(64).astype(np.float32)
    for name, kw in (("relu", {}), ("lrelu", {}), ("lrelu", {"alpha": 0.2}),
                     ("lrelu", {"negative_slope": 0.1})):
        got = layers.ACTIVATIONS[name](**kw)(torch.from_numpy(x)).numpy()
        want = np.asarray(j_layers.ACTIVATIONS[name](**kw)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", ["folded", "unfolded", "training", "int8"])
def test_conv_bn_matches_reference(rng, monkeypatch, case):
    """``conv_bn`` with the reference's signature: batch norm folded at
    inference, explicit with ``FOLD_BN`` off, batch statistics (and the
    same moving-statistic update) in training, explicit for an int8
    conv."""
    from joshupscale_tpu.export.quantize import quantize_params_int8 as jq
    from joshupscale_torch.export.quantize import quantize_params_int8

    flat = {"conv.kernel": rng.standard_normal((3, 3, 32, 32)).astype(
                np.float32) * 0.1,
            "bn.gamma": rng.uniform(0.5, 1.5, 32).astype(np.float32),
            "bn.beta": rng.standard_normal(32).astype(np.float32) * 0.1,
            "bn.moving_mean": rng.standard_normal(32).astype(np.float32),
            "bn.moving_variance": rng.uniform(0.5, 2, 32).astype(
                np.float32)}
    x = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    j_params = j_importer.unflatten_into(
        {"conv": {"kernel": jnp.zeros((3, 3, 32, 32))},
         "bn": {k: jnp.zeros(32) for k in
                ("gamma", "beta", "moving_mean", "moving_variance")}},
        flat)
    params = from_flat_numpy(flat)
    if case == "int8":
        j_params = jq(j_params, min_elements=1)
        params = quantize_params_int8(params, min_elements=1)
        assert "kernel_q" in params["conv"]
    if case == "unfolded":
        monkeypatch.setattr(common, "FOLD_BN", False)
        monkeypatch.setattr(j_common, "FOLD_BN", False)
    training = case == "training"
    mut = common.Mutables(training)

    def ref(p, x):
        j_mut = j_common.Mutables(training)
        return (j_common.conv_bn(p["conv"], p["bn"], x, j_mut, "bn"),
                j_mut.updates)

    want, j_updates = jax.jit(ref)(j_params, jnp.asarray(x))
    got = common.conv_bn(params["conv"], params["bn"], torch.from_numpy(x),
                         mut, "bn")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert common.FOLD_BN == j_common.FOLD_BN == (case != "unfolded")
    if training:
        for stat in ("moving_mean", "moving_variance"):
            np.testing.assert_allclose(mut.updates["bn"][stat].numpy(),
                                       np.asarray(j_updates["bn"][stat]),
                                       rtol=1e-5, atol=1e-6)


def test_importer_tree_functions_match_reference(tmp_path):
    """``flatten_params``, ``unflatten_into`` and the template form of
    ``load_params_npz`` against the reference's, on an inference tree
    and on a list / tuple tree."""
    built, flat = flat_params(CONFIG)
    ref_tree = j_importer.unflatten_into(built.params, flat)
    port_tree = from_flat_numpy(flat)
    _same_flat(importer.flatten_params(port_tree),
               j_importer.flatten_params(ref_tree))
    template = jax.tree_util.tree_map(torch.zeros_like, port_tree)
    back = importer.unflatten_into(template, flat)
    _same_flat(to_flat_numpy(back), flat)

    path = str(tmp_path / "ckpt.npz")
    np.savez(path, **{f"params.{k}": v for k, v in flat.items()})
    gen = importer.load_params_npz(path, template["generator"],
                                   "params.generator")
    j_gen = j_importer.load_params_npz(path, ref_tree["generator"],
                                       "params.generator")
    _same_flat(importer.flatten_params(gen), j_importer.flatten_params(j_gen))
    assert sorted(importer.load_params_npz(path, prefix="params")) == [
        "flow", "generator"]

    mixed = {"a": [torch.ones(2), (torch.zeros(3), None)], "_meta": 1}
    j_mixed = {"a": [jnp.ones(2), (jnp.zeros(3), None)], "_meta": 1}
    got = importer.flatten_params(mixed)
    _same_flat(got, j_importer.flatten_params(j_mixed))
    again = importer.unflatten_into(mixed, got)
    assert isinstance(again["a"][1], tuple) and again["a"][1][1] is None
    assert again["_meta"] == 1
    with pytest.raises(KeyError, match="Missing parameter"):
        importer.unflatten_into({"w": torch.zeros(2)}, {})
    with pytest.raises(ValueError, match="Shape mismatch"):
        importer.unflatten_into({"w": torch.zeros(2)}, {"w": np.zeros(3)})


# ---------------------------------------------------------------------------
# fit's profiler window


def _fit_with_window(tmp_path, steps, fail_at=None, batch=(2, 4)):
    def step_fn(state, batch_, rng=None):
        with torch.profiler.record_function(f"step_{state}"):
            if state == fail_at:
                raise RuntimeError("step failed")
            torch.ones(8).sum()
        return state + 1, {"loss": torch.tensor(1.0)}

    data = iter([{"x": np.zeros(2, np.float32)}] * steps)
    prof = str(tmp_path / "profile")
    return prof, lambda: trainer.fit(
        step_fn, 0, data, epochs=1, steps_per_epoch=steps,
        rng=torch.Generator(), log_fn=lambda s: None, profile_dir=prof,
        profile_batch=batch, stage_inputs=False)


def _traced_steps(prof):
    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return sorted(int(n[5:]) for n in names if n.startswith("step_"))


def test_fit_profiler_window_traces_its_steps(tmp_path):
    """Global steps 2..4 inclusive are traced, once, and written as a
    TensorBoard trace; the reference's fit writes its trace into its
    ``profile_dir`` over the same window."""
    prof, run = _fit_with_window(tmp_path, 8)
    state, _ = run()
    assert state == 8
    assert _traced_steps(prof) == [2, 3, 4]
    assert not torch.autograd.profiler._is_profiler_enabled

    j_prof = str(tmp_path / "j_profile")
    j_trainer.fit(lambda s, b, r: (s, {"loss": jnp.float32(1.0)}), 0,
                  iter([{"x": np.zeros(2, np.float32)}] * 8), epochs=1,
                  steps_per_epoch=8, rng=jax.random.PRNGKey(0),
                  log_fn=lambda s: None, profile_dir=j_prof,
                  profile_batch=(2, 4), stage_inputs=False)
    assert glob.glob(os.path.join(j_prof, "**", "*.xplane.pb"),
                     recursive=True)


def test_fit_profiler_window_closes_when_fit_raises(tmp_path):
    prof, run = _fit_with_window(tmp_path, 8, fail_at=3)
    with pytest.raises(RuntimeError, match="step failed"):
        run()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert _traced_steps(prof) == [2, 3]
    # A window beyond the run's last step never opens.
    prof2, run2 = _fit_with_window(tmp_path / "short", 3, batch=(5, 10))
    run2()
    assert not os.path.exists(prof2)
