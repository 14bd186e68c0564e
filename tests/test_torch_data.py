"""Port parity for the data pipeline (``joshupscale_torch.data``) and the
training CLI (``joshupscale_torch.training.cli``).

The pipeline is the port's own numpy copy of the reference's: from the
same PNG sequences, config and seed it must yield the reference's
batches bit for bit (the same op chain, per-op seeded generators,
decodes).  The CLI runs end to end on the CPU on a tiny YAML config and
its exported package is served by both packages.
"""

import json
import os

import numpy as np
import pytest

from joshupscale_tpu.data import (
    create_dataset as j_create_dataset,
    create_train_dataset as j_create_train_dataset,
    create_val_dataset as j_create_val_dataset,
)
from joshupscale_torch.data import (
    create_dataset,
    create_train_dataset,
    create_val_dataset,
)
from joshupscale_torch.export.weights import to_flat_numpy
from joshupscale_torch.training import load_checkpoint

CROP = 8


def _write_sequences(root, groups, lr_hw=(12, 12), seed=0):
    """``groups`` ten-frame PNG sequences under ``root/{lr,hr}``."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = lr_hw
    for sub in ("lr", "hr"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for g in range(groups):
        for i in range(10):
            hr = rng.integers(0, 256, (4 * h, 4 * w, 3), dtype=np.uint8)
            lr = hr.reshape(h, 4, w, 4, 3).mean((1, 3)).astype(np.uint8)
            name = f"seq{g:02d}_{i:02d}.png"
            cv2.imwrite(os.path.join(root, "lr", name), lr)
            cv2.imwrite(os.path.join(root, "hr", name), hr)


def test_training_cli_trains_checkpoints_and_exports(tmp_path):
    """``training.cli.main`` on a tiny YAML config (2 epochs x 2 steps,
    validation) on the CPU: finite losses in the history, best and
    latest checkpoints that load back, and an exported package that the
    reference's ``load_package`` and the port's ``create_runtime`` both
    serve; the refused options raise."""
    import yaml

    from joshupscale_tpu.export.package import load_package as j_load
    from joshupscale_torch.runtime.engine import create_runtime
    from joshupscale_torch.training import cli

    _write_sequences(str(tmp_path / "train"), 2)
    _write_sequences(str(tmp_path / "val"), 1, seed=1)
    crop = 8

    def chain(root, extra=()):
        return [{"name": "LocalDatasetOp",
                 "lr_path": str(tmp_path / root / "lr" / "*.png"),
                 "hr_path": str(tmp_path / root / "hr" / "*.png")},
                {"name": "RandomCropOp", "crop_size": crop, "num_img": 2},
                *extra]

    # 32 filters: the served package runs K1's plain version, which takes
    # C in {32, 48, 64}.
    models = {
        "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "frvsr": {"name": "frvsr", "flow": {"model": "flow"},
                  "generator": {"model": "generator"}},
    }
    models["inference"] = {"name": "inference", "flow": {"model": "flow"},
                           "generator": {"model": "generator"},
                           "skip_processing": True, "frame_height": crop,
                           "frame_width": crop}
    models["frvsr"]["inference"] = {"model": "inference"}
    config = {
        "models": models,
        "train_dataset": chain("train", [
            {"name": "RandomHorizontalFlipOp", "threshold": 0.5},
            {"name": "ShuffleOp", "shuffle_window": 4},
            {"name": "RepeatOp"}]),
        "val_dataset": chain("val"),
        "train": {"model": "frvsr", "batch_size": 2, "epochs": 2,
                  "steps_per_epoch": 2, "val_size": 2, "play_size": 2,
                  "checkpoint_dir": str(tmp_path / "ckpt"),
                  "tensorboard": False},
        "export": {"dir": str(tmp_path / "export"), "model": "inference",
                   "overrides": {"frame_height": 12, "frame_width": 16}},
    }
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    assert cli.main(["-c", str(path), "--cpu"]) == 0

    ckpt = tmp_path / "ckpt"
    assert (ckpt / "best.npz").exists() and (ckpt / "latest.npz").exists()
    history = json.loads((ckpt / "history.json").read_text())
    assert len(history) == 2
    assert all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
               for e in history)
    setup = cli.build_training(config, device="cpu")
    restored = load_checkpoint(str(ckpt / "latest.npz"), setup.state.tree())
    assert restored["step"] == 4

    package = str(tmp_path / "export" / "package")
    j_model, j_params = j_load(package)
    assert (j_model.frame_height, j_model.frame_width) == (12, 16)
    assert not j_model.skip_processing
    engine = create_runtime(package, device="cpu")
    frame = np.random.default_rng(2).integers(0, 256, (12, 16, 3),
                                              dtype=np.uint8)
    assert engine.process(frame).shape == (48, 64, 3)
    with np.load(tmp_path / "export" / "weights.npz") as w:
        np.testing.assert_array_equal(
            w["generator.conv_1.kernel"],
            to_flat_numpy(restored["params"])["generator.conv_1.kernel"])

    with pytest.raises(NotImplementedError, match="14d"):
        cli.train(config, num_devices=2, device="cpu")
    onnx = dict(config, export={"dir": str(tmp_path / "e2"), "onnx": True},
                train=dict(config["train"], epochs=1, steps_per_epoch=1,
                           checkpoint_dir=str(tmp_path / "c2")))
    with pytest.raises(NotImplementedError, match="15"):
        cli.train(onnx, device="cpu")



@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    _write_sequences(str(root), 3, lr_hw=(12, 16))
    return root


def _local(root, shuffle=False):
    return {"name": "LocalDatasetOp", "shuffle": shuffle,
            "lr_path": str(root / "lr" / "*.png"),
            "hr_path": str(root / "hr" / "*.png")}


def _chains(root):
    crop = {"name": "RandomCropOp", "crop_size": CROP, "num_img": 3}
    flips = [{"name": "RandomHorizontalFlipOp", "threshold": 0.5},
             {"name": "RandomVerticalFlipOp", "threshold": 0.5},
             {"name": "RandomTransposeOp", "threshold": 0.5}]
    return {
        "float": [_local(root, True), crop,
                  {"name": "NormalizeOp", "crop_size": CROP},
                  {"name": "FilterFlatOp", "threshold": 0.02}, *flips,
                  {"name": "RandomNoiseOp", "stddev": 0.01},
                  {"name": "RandomContrastOp", "stddev": 0.1, "base": 2.0},
                  {"name": "RandomBrightnessOp", "stddev": 0.05},
                  {"name": "ClipOp", "minval": -0.5, "maxval": 0.5},
                  {"name": "ShuffleOp", "shuffle_window": 4},
                  {"name": "RepeatOp"}],
        "u8": [_local(root, True), crop,
               {"name": "FilterFlatOp", "threshold": 5.1}, *flips[:2],
               {"name": "RgbToBgrOp"},
               {"name": "ShuffleOp", "shuffle_window": 4},
               {"name": "RepeatOp"},
               {"name": "PrefetchOp", "buffer_size": 2}],
        "single": [_local(root), crop,
                   {"name": "SingleFrameMapOp", "flow_frames": 4},
                   {"name": "SkipOp", "size": 1},
                   {"name": "OptionsOp", "options": {}},
                   {"name": "RepeatOp"}],
        "sample": [{"name": "SampleDatasetOp", "weights": [1.0, 3.0],
                    "configs": [[_local(root), crop],
                                [_local(root, True), crop,
                                 {"name": "CacheOp"}]]},
                   {"name": "RepeatOp"}],
    }


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("chain", ["float", "u8", "single", "sample"])
def test_train_dataset_yields_reference_batches(sequences, chain):
    """Eight batches of ``create_train_dataset``, bit for bit, from the
    same files, op chain and seed."""
    config = _chains(sequences)[chain]
    got = iter(create_train_dataset(config, 2, seed=7))
    want = iter(j_create_train_dataset(config, 2, seed=7))
    for _ in range(8):
        _same(next(got), next(want))


def test_val_dataset_and_sources_match_reference(sequences):
    """``create_val_dataset``'s val and play streams (cached), and the
    file-list sources ``GlobOp`` + ``ListShuffleOp``."""
    config = [_local(sequences),
              {"name": "RandomCropOp", "crop_size": CROP, "num_img": 2},
              {"name": "NormalizeOp", "crop_size": CROP}]
    got = create_val_dataset(config, 2, play_size=2, val_size=4, seed=3)
    want = j_create_val_dataset(config, 2, play_size=2, val_size=4, seed=3)
    for g, w in zip(got, want):
        g, w = list(g), list(w)
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            _same(a, b)
    files = [{"name": "GlobOp",
              "glob_pattern": str(sequences / "hr" / "*.png")},
             {"name": "ListShuffleOp"}]
    assert create_dataset(files, seed=1) == j_create_dataset(files, seed=1)


def test_unported_sources_and_workers_raise(sequences):
    """The TFRecord ops and the multiprocess loader wait for their
    ROADMAP item."""
    for op in ("TFRecordDatasetOp", "ParsePairExampleOp",
               "ParseSingleExampleOp"):
        with pytest.raises(NotImplementedError, match="14c"):
            create_dataset([{"name": op}])
    with pytest.raises(NotImplementedError, match="14c"):
        create_train_dataset(_chains(sequences)["u8"], 2, seed=0,
                             num_workers=2)
