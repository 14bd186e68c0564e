"""Port parity for the weight doors (``joshupscale_torch.export.importer``):
Keras h5 both ways, the checkpoint layouts, and the refused ONNX import.

The port's params are the template.  A port-written h5 loads in the JAX
``load_keras_h5`` to the same params and the reverse holds; a file that
tf.keras writes loads identically in both packages; the fade counter
survives; ``detect_checkpoint_prefix`` / ``load_trained_params`` read
the port's raw, FRVSR and GAN checkpoints as the reference reads them.
"""

import numpy as np
import pytest
import torch

from joshupscale_tpu.export import importer as j_importer
from joshupscale_torch.export import importer
from joshupscale_torch.export.weights import to_flat_numpy
from joshupscale_torch.models.registry import create_models

FILTERS = 32
CONFIG = {
    "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": FILTERS,
             "num_res_blocks": 2},
    "generator": {"name": "generator-resnet", "num_filters": FILTERS,
                  "num_res_blocks": 1, "num_fade_in_res_blocks": 1,
                  "fade_in_period": 8},
    "inference": {"name": "inference", "flow": {"model": "flow"},
                  "generator": {"model": "generator"},
                  "frame_height": 16, "frame_width": 24},
}


def _nest(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def _flat_of_reference(tree):
    return {k: np.asarray(v) for k, v in
            j_importer.flatten_params(tree).items()}


def _zeros_like(params):
    if isinstance(params, dict):
        return {k: _zeros_like(v) for k, v in params.items()}
    return torch.zeros_like(params)


def _same_flat(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32),
                                      err_msg=k)


@pytest.fixture(scope="module")
def params():
    """The inference params, every leaf random (BN statistics, fade
    counter 3 of period 8 included)."""
    built = create_models(CONFIG, seed=4)["inference"]
    rng = np.random.default_rng(6)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        return torch.from_numpy(np.asarray(
            rng.random(tuple(tree.shape)) + 0.5, np.float32))

    p = fill(built.params)
    p["generator"]["block_2"]["fade"]["counter"] = torch.tensor(3.0)
    p["generator"]["block_2"]["fade"]["period"] = torch.tensor(8.0)
    return p


def test_h5_crosses_both_ways(params, tmp_path):
    """Port-written h5 -> the reference's ``load_keras_h5`` and the
    reference's h5 (its legacy Keras 2 layout) -> the port's, into
    zeroed templates: the same params, the fade counter included (the
    period is layer config: the template's stands)."""
    flat = to_flat_numpy(params)
    ours = str(tmp_path / "port.h5")
    importer.save_keras_h5(ours, params)
    zeros = {k: np.zeros_like(v) for k, v in flat.items()}
    zeros["generator.block_2.fade.period"] = flat[
        "generator.block_2.fade.period"]
    _same_flat(_flat_of_reference(
        j_importer.load_keras_h5(ours, _nest(zeros))), flat)

    theirs = str(tmp_path / "reference.h5")
    j_importer.save_keras_h5(theirs, _nest(flat))
    template = _zeros_like(params)
    template["generator"]["block_2"]["fade"]["period"] = torch.tensor(8.0)
    loaded = importer.load_keras_h5(theirs, template)
    _same_flat(to_flat_numpy(loaded), flat)
    assert float(loaded["generator"]["block_2"]["fade"]["counter"]) == 3.0
    _same_flat(to_flat_numpy(importer.load_keras_h5(ours, template)), flat)

    bigger = create_models(dict(CONFIG, flow=dict(CONFIG["flow"],
                                                  num_res_blocks=3)),
                           seed=0)["inference"].params
    with pytest.raises(KeyError, match="unmatched"):
        importer.load_keras_h5(ours, bigger)


def test_tf_keras_file_loads_identically(tmp_path):
    """A flow net built and saved by tf.keras (Keras 3 ``layers/*/vars``
    layout, as ``tests/test_h5_import.py`` builds it) loads to the same
    params in both packages."""
    tf = pytest.importorskip("tensorflow")
    layers = tf.keras.layers
    inputs = [tf.keras.Input(shape=(None, None, 3)) for _ in range(4)]
    x = layers.Concatenate()(inputs)
    x = layers.Conv2D(FILTERS, 3, padding="same", use_bias=False,
                      name="conv_1")(x)
    x = layers.ReLU()(layers.BatchNormalization(name="bn_1")(x))
    for i in range(2):
        name = f"block_{i + 1}"
        shortcut = x
        for j in (1, 2):
            x = layers.Conv2D(FILTERS, 3, padding="same", use_bias=False,
                              name=f"{name}_conv_{j}")(x)
            x = layers.BatchNormalization(name=f"{name}_bn_{j}")(x)
            if j == 1:
                x = layers.ReLU()(x)
        x = layers.ReLU()(layers.Add()([x, shortcut]))
    x = layers.Conv2D(32, 1, padding="same", name="conv_2")(x)
    km = tf.keras.Model(inputs, x)
    rng = np.random.default_rng(2)
    for w in km.weights:
        w.assign(rng.standard_normal(w.shape).astype(np.float32) * 0.1
                 + (1.0 if "variance" in w.name or "gamma" in w.name
                    else 0.0))
    path = str(tmp_path / "flow.weights.h5")
    km.save_weights(path)

    template = create_models({"flow": CONFIG["flow"]})["flow"].params
    ours = to_flat_numpy(importer.load_keras_h5(path, template))
    theirs = _flat_of_reference(j_importer.load_keras_h5(
        path, _nest(to_flat_numpy(template))))
    _same_flat(ours, theirs)
    np.testing.assert_array_equal(ours["conv_1.kernel"],
                                  km.get_layer("conv_1").kernel.numpy())


def test_checkpoint_layouts_and_prefixes(params, tmp_path):
    """``detect_checkpoint_prefix`` and ``load_trained_params`` on the
    port's raw export (``save_params_npz``), FRVSR checkpoint
    (``params.``) and GAN checkpoint (``gen_params.``): the prefix the
    reference detects, the params the reference loads; ``load_onnx``
    raises as the reference's does."""
    from joshupscale_torch.training.trainer import (
        GANTrainState,
        init_train_state,
        make_optimizer,
        save_checkpoint,
    )

    flat = to_flat_numpy(params)
    opt = make_optimizer()
    raw = str(tmp_path / "weights.npz")
    importer.save_params_npz(raw, params)
    frvsr = str(tmp_path / "frvsr.npz")
    save_checkpoint(frvsr, init_train_state(params, opt, "cpu").tree())
    discr = {"conv_1": {"kernel": torch.ones(8, 3, 3, 6),
                        "bias": torch.zeros(8)}}
    gan = str(tmp_path / "gan.npz")
    save_checkpoint(gan, GANTrainState(
        params, discr, opt.init(params), opt.init(discr),
        {"t_balance1": torch.tensor(0.25), "t_balance2": torch.tensor(0.0),
         "discr_steps": 2}, 7).tree())

    template = _zeros_like(params)
    for path, prefix in ((raw, ""), (frvsr, "params"), (gan, "gen_params")):
        assert importer.detect_checkpoint_prefix(path) == prefix
        assert j_importer.detect_checkpoint_prefix(path) == prefix
        loaded = importer.load_trained_params(path, template)
        _same_flat(to_flat_numpy(loaded), flat)
        _same_flat(_flat_of_reference(j_importer.load_trained_params(
            path, _nest({k: np.zeros_like(v) for k, v in flat.items()}))),
            flat)
    sub = importer.load_params_npz(frvsr, prefix="params.generator")
    _same_flat(to_flat_numpy(sub, "generator"),
               {k: v for k, v in flat.items() if k.startswith("generator.")})
    with pytest.raises(KeyError, match="Missing parameter"):
        importer.load_trained_params(raw,
                                     dict(template, extra=template["flow"]))
    with pytest.raises(NotImplementedError, match="onnx"):
        importer.load_onnx("model.onnx", template)
