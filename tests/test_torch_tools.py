"""The port's package tools (``joshupscale_torch/tools/``) against the
reference's (``tools/``) on the CPU: the same package, frames and
weights through both, the reference tool run in this process.

- ``generate_calibration``: the ranges JSON (keys letter for letter,
  minmax values within 1e-5 relative, as
  ``tests/test_torch_quantize.py`` holds ``calibrate``);
- ``onnx_to_npz`` / ``npz_to_onnx``: the npz bit for bit with the
  reference tool's, and the round trip through a patched donor graph;
- ``onnx_verify``: the report (every frame within one u8 step), and the
  ``.onnx`` it writes byte for byte the reference's;
- ``upscale_images``: the PNGs, engine and ``--onnx`` branches, within
  u8 max 1 of the reference tool's;
- ``make_model_set``: the same file list, the packages' params equal.

The package is float32 at 32 filters (K1's plain version takes C in
{32, 48, 64}), frames 12x16.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from joshupscale_tpu.export.importer import flatten_params
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_torch.export.package import save_package
from joshupscale_torch.export.weights import from_flat_numpy
from joshupscale_torch.models.registry import create_models

H, W, SEQUENCES = 12, 16, 2


def _config(**inference):
    return {
        "flow": {"name": "flow-resnet", "num_inputs": 4, "num_filters": 32,
                 "num_res_blocks": 1},
        "generator": {"name": "generator-resnet", "num_filters": 32,
                      "num_res_blocks": 1},
        "inference": {"name": "inference", "flow": {"model": "flow"},
                      "generator": {"model": "generator"},
                      "skip_processing": False, "frame_height": H,
                      "frame_width": W, "compute_dtype": "float32",
                      **inference},
    }


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A rendered val set (``SEQUENCES`` ten-frame groups) under
    ``data/val`` and a package of the reference's seeded params."""
    import cv2

    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    for sub in ("lr", "hr"):
        os.makedirs(root / "data" / "val" / sub)
    for g in range(SEQUENCES):
        base = rng.integers(0, 256, (4 * H, 4 * W, 3)).astype(np.float32)
        for i in range(10):
            hr = np.clip(np.roll(base, 2 * i, axis=1)
                         + rng.normal(0, 8, base.shape), 0, 255)
            hr = hr.astype(np.uint8)
            lr = hr.reshape(H, 4, W, 4, 3).mean((1, 3)).astype(np.uint8)
            name = f"seq{g:02d}_{i:02d}.png"
            cv2.imwrite(str(root / "data" / "val" / "lr" / name), lr)
            cv2.imwrite(str(root / "data" / "val" / "hr" / name), hr)
    config = _config()
    flat = flatten_params(j_create_models(config)["inference"].params)
    built = create_models(config)["inference"]
    built.params = from_flat_numpy(flat)
    save_package(str(root / "package"), config, built)
    return root


def _reference(module, argv):
    """The reference tool ``tools.<module>``'s ``main()`` with
    ``argv``: (exit code, stdout)."""
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


def test_generate_calibration_matches_reference_tool(workdir):
    """The ranges JSON of a package streamed over the val sequences."""
    args = [workdir / "package", "--package", "--data", workdir / "data",
            "--sequences", SEQUENCES, "--cpu"]
    for side, run in (("port", _port), ("ref", _reference)):
        rc, out = run("generate_calibration",
                      args + ["--out", workdir / f"ranges_{side}.json"])
        assert rc == 0 and "activation ranges" in out, out
    got = json.loads((workdir / "ranges_port.json").read_text())
    want = json.loads((workdir / "ranges_ref.json").read_text())
    assert list(got) == list(want) and len(got) > 4
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v + 1e-7, (k, got[k], v)


def test_calibration_fidelity_matches_reference_tool(workdir):
    """The three calibrators' table on a checkpoint at the fast
    architecture's widths (bf16 engines): the reference tool's rows, each
    row's PSNR (and the bf16 engine's) within 0.05 dB of the reference's,
    its mean u8 error against the bf16 engine within 0.1 and its p99
    within one step (bf16 and int8 engines on two backends)."""
    from joshupscale_torch.export.importer import save_params_npz
    from joshupscale_torch.tools.val_data import arch_config

    config = arch_config("fast", H, W)
    flat = flatten_params(j_create_models(config)["inference"].params)
    ckpt = workdir / "fast.npz"
    save_params_npz(str(ckpt), from_flat_numpy(flat))
    args = [ckpt, "--data", workdir / "data", "--cal-sequences", 1,
            "--arch", "fast", "--cpu"]
    tables = []
    for run in (_port, _reference):
        rc, text = run("calibration_fidelity", args)
        assert rc == 0, text
        bf16 = float(text.split("bf16 engine held-out PSNR: ")[1].split()[0])
        rows = {}
        for line in text.splitlines():
            cells = [c.strip() for c in line.split("|")[1:-1]]
            if len(cells) == 3 and cells[0] not in ("Calibrator", "---"):
                mean, p99, mx = (float(x) for x in cells[1].split(" / "))
                rows[cells[0]] = (mean, p99, float(cells[2].split()[0]))
        tables.append((bf16, rows))
    (bf16, got), (bf16_ref, want) = tables
    assert abs(bf16 - bf16_ref) <= 0.05
    assert list(got) == list(want) == ["minmax", "percentile (99.9%)",
                                       "entropy"]
    for name, (mean, p99, db) in want.items():
        g_mean, g_p99, g_db = got[name]
        assert abs(g_mean - mean) <= 0.1, (name, got[name], want[name])
        assert abs(g_p99 - p99) <= 1 and abs(g_db - db) <= 0.05, name


def test_onnx_npz_round_trip_matches_reference_tool(workdir):
    """``onnx_to_npz`` on the port's export: the reference tool's npz bit
    for bit; ``npz_to_onnx`` patches new weights into that donor, and
    both packages' ``onnx_to_npz`` read them back exactly; an npz of the
    wrong shape is refused."""
    from joshupscale_torch.export.onnx_export import export_onnx
    from joshupscale_torch.export.package import load_package
    from joshupscale_torch.tools import npz_to_onnx, onnx_to_npz
    import tools.onnx_to_npz as ref_onnx_to_npz

    _, params = load_package(str(workdir / "package"))
    donor = str(workdir / "donor.onnx")
    export_onnx(donor, params, H, W)
    with contextlib.redirect_stdout(io.StringIO()):
        assert onnx_to_npz.main(donor, str(workdir / "port.npz")) == 0
        assert ref_onnx_to_npz.main(donor, str(workdir / "ref.npz")) == 0
    with np.load(workdir / "port.npz") as p, np.load(workdir / "ref.npz") as r:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
            assert p[k].dtype == r[k].dtype
        rng = np.random.default_rng(5)
        new = {k: (r[k] + rng.standard_normal(r[k].shape) * 0.01
                   ).astype(r[k].dtype) if r[k].dtype == np.float32
               else r[k] for k in r.files}
    np.savez(workdir / "new.npz", **new)
    out = str(workdir / "patched.onnx")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        assert npz_to_onnx.main(donor, str(workdir / "new.npz"), out) == 0
    assert f"patched {len(new)}/{len(new)}" in log.getvalue()
    for tool, path in ((onnx_to_npz, "back_port.npz"),
                       (ref_onnx_to_npz, "back_ref.npz")):
        with contextlib.redirect_stdout(io.StringIO()):
            assert tool.main(out, str(workdir / path)) == 0
        with np.load(workdir / path) as back:
            assert sorted(back.files) == sorted(new)
            for k, v in new.items():
                np.testing.assert_array_equal(back[k], v, err_msg=k)
    bad = dict(new)
    key = next(k for k, v in new.items() if v.ndim == 4)
    bad[key] = new[key][..., :1]
    np.savez(workdir / "bad.npz", **bad)
    with contextlib.redirect_stderr(io.StringIO()) as err, \
            contextlib.redirect_stdout(io.StringIO()):
        assert npz_to_onnx.main(donor, str(workdir / "bad.npz"),
                                str(workdir / "bad.onnx")) == 1
    assert "donor shape" in err.getvalue()


def test_onnx_verify_matches_reference_tool(workdir):
    """The report over 4 frames: exit 0 and every frame within one u8
    step on both sides, and the ``.onnx`` written byte for byte the
    reference tool's."""
    args = [workdir / "package", "--data", workdir / "data", "--frames", 4]
    rc, port = _port("onnx_verify", args + ["--out", workdir / "v_port.onnx",
                                            "--cpu"])
    assert rc == 0, port
    rc, ref = _reference("onnx_verify", args + ["--out",
                                                workdir / "v_ref.onnx"])
    assert rc == 0, ref
    for text in (port, ref):
        diffs = [int(line.split("diff ")[1].split()[0])
                 for line in text.splitlines() if line.startswith("frame ")]
        assert len(diffs) == 4 and max(diffs) <= 1, text
    assert ((workdir / "v_port.onnx").read_bytes()
            == (workdir / "v_ref.onnx").read_bytes())


def test_upscale_images_matches_reference_tool(workdir):
    """4 frames through the engine and through ``--onnx``: the PNGs of
    each branch within one u8 step of the reference tool's."""
    import cv2

    from joshupscale_torch.export.onnx_export import export_onnx
    from joshupscale_torch.export.package import load_package

    _, params = load_package(str(workdir / "package"))
    onnx = str(workdir / "up.onnx")
    export_onnx(onnx, params, H, W)
    frames = str(workdir / "data" / "val" / "lr" / "seq00_0[0-3].png")
    for branch in ((), ("--onnx", onnx)):
        outs = {}
        for side, run in (("port", _port), ("ref", _reference)):
            out_dir = workdir / f"up_{side}{len(branch)}"
            rc, text = run("upscale_images", ["-p", workdir / "package",
                                              "-o", out_dir, "--cpu",
                                              *branch, frames])
            assert rc == 0 and "processed 4 images" in text, text
            outs[side] = [cv2.imread(str(out_dir / f"seq00_0{i}.png"))
                          for i in range(4)]
        for got, want in zip(outs["port"], outs["ref"]):
            assert got.shape == want.shape == (4 * H, 4 * W, 3)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_make_model_set_matches_reference_tool(workdir):
    """Both tools lay out the four packages and the mask from tiny tier
    configs with a checkpoint for each tier: the same files, and each
    package's params equal.  The port takes ``--no-stablehlo`` and
    changes nothing."""
    import yaml

    from joshupscale_torch.export.importer import save_params_npz
    from joshupscale_torch.tools.make_model_set import MODEL_CONFIGS

    ae = _config(flow_pad_factor=2, normalize_brightness=True)
    ae["flow"] = {"name": "flow-autoencoder", "num_inputs": 4,
                  "filters": [4, 8, 4]}
    configs, weights = [], []
    for name in MODEL_CONFIGS:
        doc = ae if "ps2" in name else _config()
        path = workdir / f"{name}.yaml"
        path.write_text(yaml.safe_dump({"models": doc}))
        ckpt = workdir / f"{name}.npz"
        save_params_npz(str(ckpt), from_flat_numpy(flatten_params(
            j_create_models(doc, seed=3)["inference"].params)))
        configs += ["--config", f"{name}={path}"]
        weights += ["--weights", f"{name}={ckpt}"]
    rc, _ = _port("make_model_set", ["--out", workdir / "set_port",
                                     "--no-stablehlo", *configs, *weights])
    assert rc == 0
    rc, _ = _reference("make_model_set", ["--out", workdir / "set_ref",
                                          "--no-stablehlo", "--cpu",
                                          *configs, *weights])
    assert rc == 0

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(workdir / "set_port") == files(workdir / "set_ref")
    assert "mask.png" in files(workdir / "set_port")
    for name in MODEL_CONFIGS:
        with np.load(workdir / "set_port" / name / "params.npz") as p, \
                np.load(workdir / "set_ref" / name / "params.npz") as r:
            assert sorted(p.files) == sorted(r.files)
            for k in r.files:
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
