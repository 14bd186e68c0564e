"""The port's model-quality tools (``joshupscale_torch/tools/``) against
the reference's (``tools/``) on the CPU, the reference tool run in this
process (``sys.argv`` patched), at a small size: nets of 32 filters and
1 res block in float32 (the ``narrow`` fixture patches both registries'
``create_models``), LR frames 12x12 (the rendered set) or 12x16.

- ``make_synth_dataset``: PNG frames decoded equal, TFRecord files byte
  for byte, from the same numpy-made source image;
- ``keras_vgg_to_npz``: both h5 layouts (a VGG19 topology with narrow
  channels), the npz bit for bit;
- ``bn_recalibrate``: the same key set, the moving statistics within
  ``BN_RTOL`` of the reference's (each side's own forward, the same
  batches and the reference's noise draws), every other leaf equal;
- ``eval_synth``: checkpoint, ``--package``, ``--zero-init`` and
  ``--u8-state --pingpong``; the PSNRs within ``PSNR_TOL`` dB;
- ``eval_serving_fullres``: the PSNRs within ``PSNR_TOL`` dB;
- ``drift_1000`` at T = 12 (``SIZES`` patched): the clip bit for bit,
  the summary's keys, stream against clip 0, the u8-state figures
  within u8 1;
- ``gan_soak``: ``synth_video_batch`` bit for bit; two narrow steps of
  the port with finite losses (the step itself is held against the
  reference in ``tests/test_torch_gan.py``).
"""

import contextlib
import io
import json
import re
import sys

import numpy as np
import pytest

import joshupscale_tpu.models as j_models
import joshupscale_torch.models.registry as t_registry
from joshupscale_tpu.export.importer import flatten_params
from joshupscale_torch.export.package import save_package
from joshupscale_torch.export.weights import from_flat_numpy

PSNR_TOL = 0.01  # dB, port against reference
PINGPONG_TOL = 0.01  # u8 steps
BN_RTOL = 1e-3  # recalibrated moving statistics, relative to max(|ref|, 1)
FILTERS, BLOCKS = 32, 1  # K1's plain version takes C in {32, 48, 64}


def _narrow_config(config):
    out = {}
    for name, entry in config.items():
        entry = dict(entry) if isinstance(entry, dict) else entry
        if isinstance(entry, dict) and entry.get("name") in (
                "flow-resnet", "generator-resnet"):
            entry.update(num_filters=FILTERS, num_res_blocks=BLOCKS)
        if isinstance(entry, dict) and entry.get("name") == "inference":
            entry["compute_dtype"] = "float32"
        out[name] = entry
    return out


@pytest.fixture()
def narrow(monkeypatch):
    """Both registries build the resnets at ``FILTERS`` x ``BLOCKS`` and
    the inference model in float32, whatever the tool asks for."""
    for module in (j_models, t_registry):
        build = module.create_models
        monkeypatch.setattr(
            module, "create_models",
            lambda config, *a, _b=build, **k: _b(_narrow_config(config),
                                                 *a, **k))


def _reference(module, argv):
    """The reference tool ``tools.<module>``'s ``main()`` with ``argv``:
    (exit code, stdout)."""
    import importlib

    main = importlib.import_module(f"tools.{module}").main
    saved = sys.argv
    sys.argv = [module] + [str(a) for a in argv]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main()
    finally:
        sys.argv = saved
    return rc, out.getvalue()


def _port(module, argv):
    import importlib

    main = importlib.import_module(f"joshupscale_torch.tools.{module}").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue()


def _source(h=900, w=1300):
    """A smooth colour pattern with noise, (h, w, 3) u8."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(x * 0.05 + c) * np.cos(y * 0.03 - c)
                    for c in range(3)], -1) * 100 + 128
    return np.clip(img + rng.normal(0, 10, img.shape), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The source image, the rendered set of both tools (2 train, 2 val
    sequences, HR 48), a checkpoint and a package of the reference's
    seeded params (12x12, float32)."""
    import cv2

    from joshupscale_tpu.models import create_models as j_create

    root = tmp_path_factory.mktemp("quality")
    cv2.imwrite(str(root / "source.png"), _source())
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("make_synth_dataset", [
            root / side, "--source", root / "source.png", "--train", 2,
            "--val", 2, "--hr-size", 48])
        assert rc == 0 and "val: 2 sequences" in out, out
    config = _narrow_config(_ckpt_config(12, 12))
    flat = flatten_params(j_create(config)["inference"].params)
    np.savez(root / "ckpt.npz", step=np.int32(7),
             **{f"params.{k}": v for k, v in flat.items()})
    built = t_registry.create_models(config)["inference"]
    built.params = from_flat_numpy(flat)
    save_package(str(root / "package"), config, built)
    return root


def _ckpt_config(h, w):
    from joshupscale_torch.tools.val_data import arch_config

    return arch_config("quality", h, w, "float32")


@pytest.mark.parametrize("fmt", ["png", "tfrecords"])
def test_make_synth_dataset_matches_reference(tmp_path, fmt):
    import cv2

    cv2.imwrite(str(tmp_path / "source.png"), _source(300, 400))
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("make_synth_dataset", [
            tmp_path / side, "--source", tmp_path / "source.png", "--train",
            2, "--val", 1, "--hr-size", 64, "--seed", 3, "--format", fmt])
        assert rc == 0, out
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*") if p.is_file())
    want = sorted(p.relative_to(tmp_path / "ref")
                  for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert got == want and len(got) == (60 if fmt == "png" else 2)
    for rel in got:
        a, b = tmp_path / "port" / rel, tmp_path / "ref" / rel
        if fmt == "png":
            assert np.array_equal(cv2.imread(str(a)), cv2.imread(str(b)))
        else:
            assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("layout", ["legacy", "keras3"])
def test_keras_vgg_to_npz_matches_reference(tmp_path, monkeypatch, layout):
    """A VGG19 topology at narrow widths (both tools' ``_CHANNELS``
    patched) in either h5 layout, with datasets outside the conv layers
    that the tools must skip."""
    import h5py

    import joshupscale_torch.tools.keras_vgg_to_npz as t_tool
    import tools.keras_vgg_to_npz as j_tool

    channels, cin = {}, 3
    for layer in j_tool._CHANNELS:
        channels[layer] = (cin, cin + 1)
        cin += 1
    for tool in (j_tool, t_tool):
        monkeypatch.setattr(tool, "_CHANNELS", channels)
    rng = np.random.default_rng(1)
    h5 = tmp_path / "vgg.h5"
    with h5py.File(h5, "w") as f:
        for layer, (ci, co) in channels.items():
            kernel = rng.standard_normal((3, 3, ci, co)).astype(np.float32)
            bias = rng.standard_normal(co).astype(np.float32)
            if layer == "block5_conv4":  # an f64 layer: converted to f32
                kernel, bias = kernel.astype(np.float64), bias.astype(
                    np.float64)
            if layout == "legacy":
                g = f.create_group(layer)
                g.attrs["weight_names"] = [f"{layer}/kernel:0",
                                           f"{layer}/bias:0"]
                g.create_dataset(f"{layer}/kernel:0", data=kernel)
                g.create_dataset(f"{layer}/bias:0", data=bias)
            else:
                g = f.create_group(f"layers/{layer}/vars")
                g.create_dataset("0", data=kernel)
                g.create_dataset("1", data=bias)
        f.create_dataset("optimizer/vars/0", data=np.zeros(3))
        f.create_dataset("flatten/vars/0", data=np.zeros((2, 2)))
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("keras_vgg_to_npz", [h5, tmp_path / f"{side}.npz"])
        assert rc == 0 and "32 arrays" in out, out
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "ref.npz") as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.float32
            assert np.array_equal(got[k], want[k]), k


def test_bn_recalibrate_matches_reference(workdir, tmp_path, monkeypatch):
    """Both tools over the same two batches of the rendered set (each
    tool's ``create_train_dataset`` patched to yield them), the port fed
    the reference's noise draws (``jax.random.fold_in(PRNGKey(0), i)``);
    the checkpoint is an FRVSR train state with a leaf outside the
    params."""
    import jax
    import jax.numpy as jnp
    import yaml

    import joshupscale_tpu.data.pipeline as j_pipeline
    import joshupscale_torch.data.pipeline as t_pipeline
    from joshupscale_torch.training.frvsr import FRVSRTrainer

    data = workdir / "port" / "train"
    chain = [{"name": "LocalDatasetOp", "lr_path": f"{data}/lr/*.png",
              "hr_path": f"{data}/hr/*.png"},
             {"name": "RandomCropOp", "crop_size": 8, "num_img": 10},
             {"name": "NormalizeOp", "crop_size": 8}]
    models = _narrow_config(_ckpt_config(8, 8))
    models["inference"].update(skip_processing=True)
    config = tmp_path / "cfg.yaml"
    config.write_text(yaml.safe_dump({"models": models,
                                      "train_dataset": chain}))
    ds = t_pipeline.create_train_dataset(chain, 2, seed=0)
    batches = [next(iter(ds)) for _ in range(2)]
    for module in (j_pipeline, t_pipeline):
        monkeypatch.setattr(module, "create_train_dataset",
                            lambda *a, **k: iter(batches))

    def reference_noise(self, shape, gen, device):
        import torch

        key = jax.random.fold_in(jax.random.PRNGKey(0), len(drawn))
        b, _, h, w, _ = shape
        k_hist, k_first = jax.random.split(key)
        drawn.append(shape)
        return {"first_warp": torch.from_numpy(np.array(jax.random.uniform(
                    k_first, (b, 4 * h, 4 * w, 3), jnp.float32, -0.5, 0.5))),
                "history": torch.from_numpy(np.array(jax.random.uniform(
                    k_hist, (b, 2, h, w, 3), jnp.float32, -0.5, 0.5)))}

    drawn = []
    monkeypatch.setattr(FRVSRTrainer, "draw_noise", reference_noise)
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("bn_recalibrate", [
            workdir / "ckpt.npz", "-c", config, "-o", tmp_path /
            f"{side}.npz", "--batches", 2, "--batch-size", 2, "--cpu"])
        assert rc == 0 and "recalibrated" in out, out
    assert len(drawn) == 2
    with np.load(workdir / "ckpt.npz") as before, \
            np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "ref.npz") as want:
        assert sorted(got.files) == sorted(want.files) == sorted(
            before.files)
        stats = [k for k in want.files if k.endswith(("moving_mean",
                                                      "moving_variance"))]
        assert len(stats) >= 4, stats
        for k in want.files:
            if k in stats:
                scale = np.maximum(np.abs(want[k]), 1.0)
                assert np.all(np.abs(got[k] - want[k]) <= BN_RTOL * scale), k
                assert not np.array_equal(got[k], before[k]), k
            else:
                assert np.array_equal(got[k], before[k]), k
                assert np.array_equal(want[k], before[k]), k


@pytest.fixture()
def psnrs(monkeypatch):
    """The PSNRs each side's tool computes, unrounded, in call order:
    ``{"port": [...], "ref": [...]}`` (model, then bilinear)."""
    import joshupscale_torch.tools.val_data as t_val
    import tools.eval_serving_fullres as j_full
    import tools.eval_synth as j_synth

    seen = {"port": [], "ref": []}
    for side, module in (("port", t_val), ("ref", j_synth),
                         ("ref", j_full)):
        def record(a, b, _f=module.psnr, _side=side):
            seen[_side].append(_f(a, b))
            return seen[_side][-1]

        monkeypatch.setattr(module, "psnr", record)
    return seen


_EVAL_CASES = {
    "checkpoint": lambda d: [d / "ckpt.npz"],
    "package": lambda d: [d / "package", "--package"],
    "zero_init": lambda d: ["random", "--zero-init"],
    "u8_state_pingpong": lambda d: [d / "ckpt.npz", "--u8-state",
                                    "--pingpong"],
}


@pytest.mark.parametrize("case", sorted(_EVAL_CASES))
def test_eval_synth_matches_reference(workdir, narrow, psnrs, case):
    """Each side reads its own tool's rendered set (the same frames)."""
    res = {}
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("eval_synth", _EVAL_CASES[case](workdir) + [
            "--data", workdir / side, "--cpu"])
        assert rc == 0 and "val: 2 sequences of 10 frames, 12x12" in out, out
        res[side] = out
    got, want = psnrs["port"], psnrs["ref"]
    assert len(got) == len(want) == 2
    assert np.all(np.abs(np.subtract(got, want)) <= PSNR_TOL), (got, want)
    if case == "zero_init":
        # A zero tail serves the bilinear skip (identity warp): the port's
        # frames are the baseline's; the reference's jitted display lands
        # 0.009 dB off its own baseline on these frames.
        assert abs(got[0] - got[1]) <= PSNR_TOL, got
    if case == "u8_state_pingpong":
        pp = [float(re.search(r"ping-pong inconsistency: ([0-9.]+)",
                              res[s]).group(1)) for s in ("port", "ref")]
        assert abs(pp[0] - pp[1]) <= PINGPONG_TOL, pp


def test_eval_serving_fullres_matches_reference(workdir, narrow, psnrs):
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("eval_serving_fullres", [
            workdir / "ckpt.npz", "--source", workdir / "source.png",
            "--frames", 4, "--height", 12, "--width", 16, "--cpu"])
        assert rc == 0 and "clip: 4 frames 16x12 -> 64x48" in out, out
    got, want = psnrs["port"], psnrs["ref"]
    assert len(got) == len(want) == 2
    assert np.all(np.abs(np.subtract(got, want)) <= PSNR_TOL), (got, want)


def test_drift_matches_reference(workdir, narrow, monkeypatch):
    """T = 12 in chunks of 5, 12x16 frames, checkpoints 3, 7, 11: the
    reference's module constants and the port's ``SIZES`` patched, the
    reference's fixed source path read as the test's source."""
    import cv2

    import joshupscale_tpu.runtime.engine as j_engine
    import joshupscale_torch.tools.drift_1000 as t_tool
    import tools.drift_1000 as j_tool

    marks = (3, 7, 11)
    for name, v in (("T", 12), ("CHUNK", 5), ("CHECKPOINTS", marks),
                    ("H", 12), ("W", 16)):
        monkeypatch.setattr(j_tool, name, v)
    sizes = t_tool.Sizes(frames=12, height=12, width=16, chunk=5,
                         checkpoints=marks)
    monkeypatch.setattr(t_tool, "SIZES", sizes)
    monkeypatch.setattr(j_engine, "enable_compilation_cache", lambda: None)
    src = cv2.imread(str(workdir / "source.png"))
    # Whatever path a tool reads, it gets the test's source.
    monkeypatch.setattr(cv2, "imread", lambda *a: src.copy())
    assert np.array_equal(t_tool.make_clip(src), j_tool.make_clip())

    res = {}
    for side, run, argv in (
            ("port", _port, ["--source", workdir / "source.png", "--cpu"]),
            ("ref", _reference, [])):
        rc, out = run("drift_1000", argv)
        assert rc == 0, out
        res[side] = json.loads(out.strip().splitlines()[-1])
    got, want = res["port"], res["ref"]
    assert got.keys() == want.keys()
    assert got["u8_state_vs_float"].keys() == want["u8_state_vs_float"].keys()
    assert got["frames"] == want["frames"] == 12
    assert got["stream_vs_clip_max_u8"] == {str(c): 0 for c in marks}
    assert want["stream_vs_clip_max_u8"] == {str(c): 0 for c in marks}
    g, w = got["u8_state_vs_float"], want["u8_state_vs_float"]
    for k in ("mean_u8_steps_overall", "p99_u8_steps_overall",
              "p99_of_frame_p99s", "max_u8_steps_overall"):
        assert abs(g[k] - w[k]) <= 1, (k, g, w)
    for k in ("mean_by_checkpoint", "max_by_checkpoint"):
        assert g[k].keys() == w[k].keys()
        assert all(abs(g[k][c] - w[k][c]) <= 1 for c in w[k]), (k, g, w)


def test_drift_stats_match_numpy():
    """The histogram route's per-frame mean / p99 / max against numpy's
    on the same differences (what the reference computes per frame)."""
    import torch

    from joshupscale_torch.tools.drift_1000 import (
        diff_histograms,
        frame_stats,
    )

    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (3, 1, 37, 41, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-9, 9, a.shape), 0,
                255).astype(np.uint8)
    b[1] = a[1]  # a frame without a difference
    for t, h in enumerate(diff_histograms(a, b, torch.device("cpu"))):
        d = np.abs(a[t].astype(np.int16) - b[t].astype(np.int16))
        assert frame_stats(h) == (float(d.mean()),
                                  float(np.percentile(d, 99)),
                                  int(d.max()))


def test_gan_soak_batches_and_narrow_steps(monkeypatch):
    import joshupscale_torch.tools.gan_soak as t_tool
    import tools.gan_soak as j_tool

    for crop, b in ((8, 2), (4, 1)):
        got = t_tool.synth_video_batch(np.random.default_rng(5), b, crop)
        want = j_tool.synth_video_batch(np.random.default_rng(5), b, crop)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    monkeypatch.setattr(t_tool, "GAN_CONFIG",
                        _narrow_config(t_tool.GAN_CONFIG))
    rc, out = _port("gan_soak", ["--steps", 2, "--crop", 8, "--batch", 1,
                                 "--log-every", 1, "--cpu"])
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [m["step"] for m in lines] == [0, 1], out
    assert all(np.isfinite(v) for m in lines for v in m.values()), out
    assert "content loss decreased:" in out and rc in (0, 1), out


def test_learning_run_config():
    """``learning_run``'s copy of the learning config: the epochs and
    steps it is given, the datasets read from the rendered set and every
    output under ``--out``; the original dict untouched."""
    from pathlib import Path

    from joshupscale_torch.tools.learning_run import learning_config
    from joshupscale_torch.training.cli import load_config

    path = Path(__file__).parents[1] / "configs" / "frvsr_synth_learn.yaml"
    config = load_config(str(path))
    got = learning_config(config, "/d", "/o", 10, 150)
    assert (got["train"]["epochs"], got["train"]["steps_per_epoch"]) == (
        10, 150)
    assert config["train"]["epochs"] == 40
    assert got["train_dataset"][0]["lr_path"] == "/d/train/lr/**/*.png"
    assert got["val_dataset"][0]["hr_path"] == "/d/val/hr/**/*.png"
    assert got["train"]["checkpoint_dir"] == got["train"]["log_dir"] == (
        "/o/ckpt")
    assert got["export"]["dir"] == "/o/export"
    assert got["models"] == config["models"]
