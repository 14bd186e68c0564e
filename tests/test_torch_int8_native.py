"""The int8 tier on the Python-free backend, on the CPU, and the serving
set's spec for every serving option.

An int8 model (``quantize_params_int8``, with dynamic activation scales
and with ranges from ``calibrate``) leaves both sides as a Python-free
serving set: the reference's ``save_package(export_stablehlo=True)`` and
the port's ``save_package(export_aoti=True)``.  Their ``step_spec.txt``
and ``state_init.bin`` are the same bytes; the port's ``step.pt2`` is
``Engine``'s frames bit for bit, in process and through ``upscale_cli``,
and the reference's StableHLO step's within u8 1.  Neither side's
``load_package`` takes an int8 package (its params are not the float
template's), so the embedded-Python backend cannot serve one.

The resnet family (16x24, dynamic scales) and the PS2 family (15x24,
calibrated ranges) of ``tests/test_torch_native.py``, f32, every conv of
at least 64 weights quantized.  Host and reference run torch on one
thread, as in that file.
"""

import contextlib
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import u8_diff, u8_frames
from joshupscale_tpu.export import quantize as jq
from joshupscale_tpu.export.package import load_package as j_load_package
from joshupscale_tpu.export.package import load_stablehlo_step
from joshupscale_tpu.export.package import save_package as j_save_package
from joshupscale_tpu.models import create_models as j_create_models
from joshupscale_tpu.runtime.native_glue import NativeEngine as JNativeEngine
from joshupscale_torch import native
from joshupscale_torch.export import quantize as tq
from joshupscale_torch.export.package import (
    export_step,
    load_aoti_step,
    load_package,
    save_package,
    state_leaves,
    write_serving_spec,
)
from joshupscale_torch.models.registry import create_models
from joshupscale_torch.runtime.native_glue import NativeEngine
from test_torch_cuda import _ARTIFACT_CASES
from test_torch_native import (
    SEED,
    W,
    _built_pair,
    _engine_bytes,
    _env,
    _ps2_config,
    _resnet_config,
)

T = 4
MIN_ELEMENTS = 64
_FAMILIES = {"resnet": (_resnet_config, False), "ps2": (_ps2_config, True)}


def _int8_pair(family, frames):
    """(the reference's built entry, the port's) holding the same int8
    params: one set of float params quantized on each side, with the
    ranges the port's ``calibrate`` takes on the CPU over ``frames``
    where the family is calibrated."""
    make, calibrated = _FAMILIES[family]
    config = make()
    j_built, built = _built_pair(config)
    ranges = None
    if calibrated:
        ranges = tq.calibrate(built.obj, built.params, frames[:, None],
                              device="cpu")
    j_built.params = jq.quantize_params_int8(
        j_built.params, min_elements=MIN_ELEMENTS, ranges=ranges)
    built.params = tq.quantize_params_int8(
        built.params, min_elements=MIN_ELEMENTS, ranges=ranges)
    return config, j_built, built, ranges


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host():
    return native.build()


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """Each family's int8 packages, the reference's with
    ``export_stablehlo`` and the port's with ``export_aoti`` (for the
    CPU, on one thread, as it is run), with the built entries and the
    recurrent frames."""
    out = {}
    for family in _FAMILIES:
        make = _FAMILIES[family][0]
        h = make()["inference"]["frame_height"]
        frames = u8_frames(np.random.default_rng(31), T, h, W)
        config, j_built, built, ranges = _int8_pair(family, frames)
        root = tmp_path_factory.mktemp(family)
        j_save_package(str(root / "jax"), config, j_built,
                       export_stablehlo=True)
        with _one_thread():
            save_package(str(root / "port"), config, built,
                         export_aoti=True, device="cpu")
        out[family] = {"jax": str(root / "jax"), "port": str(root / "port"),
                       "j_built": j_built, "built": built, "frames": frames,
                       "ranges": ranges, "h": h}
    return out


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_int8_serving_spec_matches_reference(packages, family):
    """The int8 set's ``step_spec.txt`` letter for letter and
    ``state_init.bin`` byte for byte the reference's, and every conv of
    at least ``MIN_ELEMENTS`` weights quantized (the calibrated family
    with a static scale on each)."""
    pkg = packages[family]
    for name in ("step_spec.txt", "state_init.bin"):
        assert (Path(pkg["port"], name).read_bytes()
                == Path(pkg["jax"], name).read_bytes()), name
    params = pkg["built"].params
    assert tq.quantized_convs(params) >= 4
    if pkg["ranges"] is not None:
        assert len(pkg["ranges"]) >= tq.quantized_convs(params["generator"])


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_int8_aoti_step_matches_engine_and_stablehlo(packages, family):
    """``load_aoti_step`` of the int8 set over recurrent frames, on one
    thread, against ``Engine`` (CPU, one thread) and the reference's
    ``load_stablehlo_step``.  The resnet family gives ``Engine``'s bytes
    bit for bit.  The PS2 family's brightness mean is a reduction that
    inductor's code sums in another order than eager's, so its padded
    frame state is 1 f32 ulp off from frame 0; a calibrated (static)
    scale turns that into one int8 level now and then, and a few display
    values move by 1 (ROADMAP section 3): held within u8 1 of
    ``Engine``, on under 1% of the values.  Against the reference: u8
    within 1 (the float convs, warps and tails sum in other orders)."""
    pkg = packages[family]
    step = load_aoti_step(pkg["port"])
    j_step = load_stablehlo_step(pkg["jax"])
    state = state_leaves(pkg["built"].obj.init_state(1, device="cpu"))
    j_state = pkg["j_built"].obj.init_state(1)
    ref = _engine_bytes(pkg["built"], pkg["frames"])
    for t, frame in enumerate(pkg["frames"]):
        with _one_thread():
            out, *state = step(torch.from_numpy(frame[None]), *state)
        j_out, j_state = j_step(frame[None], j_state)
        if family == "resnet":
            np.testing.assert_array_equal(out[0].numpy(), ref[t])
        else:
            d = u8_diff(out[0].numpy(), ref[t])
            assert d.max() <= 1 and (d > 0).mean() < 0.01, (t, d.max())
        assert u8_diff(out[0].numpy(), np.asarray(j_out)[0]).max() <= 1


def test_int8_graph_holds_one_int_mm_a_quantized_conv():
    """The exported int8 step holds one ``aten._int_mm`` a quantized conv
    (a 4-D ``kernel_q`` leaf), whatever the net: the product is not folded,
    split or replaced by a float conv."""
    for family in _FAMILIES:
        _, _, built, _ = _int8_pair(family, None if family == "resnet"
                                    else u8_frames(np.random.default_rng(3),
                                                   2, 15, W))
        program, _ = export_step(built.obj, built.params, device="cpu")
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"]
        assert (targets.count("aten._int_mm.default")
                == tq.quantized_convs(built.params)), family


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipeline"])
def test_int8_upscale_cli_python_free(host, packages, tmp_path, pipeline):
    """``upscale_cli`` over the port with the Python-free backend serves
    the int8 resnet set: ``Engine``'s bytes, synchronous and pipelined."""
    pkg = packages["resnet"]
    pkg["frames"].tofile(tmp_path / "in.raw")
    args = (["--pipeline"] if pipeline else []) + [
        pkg["port"], str(tmp_path / "in.raw"), str(tmp_path / "out.raw")]
    result = subprocess.run([str(host / "upscale_cli"), *args],
                            env=_env(JOSHUPSCALE_TORCH_AOTI="1"),
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-4000:]
    assert "AOTInductor engine loaded" in result.stderr
    assert f"processed {T} frames" in result.stderr
    out = np.fromfile(tmp_path / "out.raw", np.uint8).reshape(
        (T, 4 * pkg["h"], 4 * W, 3))
    np.testing.assert_array_equal(out, _engine_bytes(pkg["built"],
                                                     pkg["frames"]))


def test_int8_package_refused_without_the_serving_set(host, packages,
                                                      tmp_path):
    """An int8 package's ``params.npz`` does not fit the float template:
    ``load_package`` raises ``KeyError`` on both sides, and so the
    reference's ``NativeEngine``, the port's and the embedded-Python
    backend of ``upscale_cli`` refuse the package (the reference's
    behaviour, pinned).  Only the Python-free set serves it."""
    pkg = packages["resnet"]
    for path in (pkg["jax"], pkg["port"]):
        with pytest.raises(KeyError):
            j_load_package(path)
        with pytest.raises(KeyError):
            load_package(path)
    with pytest.raises(KeyError):
        JNativeEngine(pkg["jax"], 0)
    with pytest.raises(KeyError):
        NativeEngine(pkg["port"], "cpu")
    pkg["frames"][:1].tofile(tmp_path / "in.raw")
    result = subprocess.run(
        [str(host / "upscale_cli"), pkg["port"], str(tmp_path / "in.raw"),
         str(tmp_path / "out.raw")], env=_env(), capture_output=True,
        text=True, timeout=120)
    assert result.returncode != 0
    assert ("error:" in result.stderr
            and "parameter mismatch" in result.stderr), (
        result.stderr[-2000:])


# Every serving option of the inference model, with its batch size: the
# card tests' artifacts and, besides them, the eager display and bf16.
_OPTIONS = {**_ARTIFACT_CASES,
            "eager_display": ({"deferred_display": False}, 1),
            "bfloat16": ({"compute_dtype": "bfloat16"}, 1)}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
@pytest.mark.parametrize("option", list(_OPTIONS))
def test_serving_option_spec_matches_reference(tmp_path, option, family):
    """``write_serving_spec`` (the export, no compile) against the
    reference's ``export_stablehlo`` set, for each serving option on each
    family: ``step_spec.txt`` letter for letter (the state leaves, their
    dtypes and shapes, the frame's dtype, the batch) and
    ``state_init.bin`` byte for byte."""
    options, batch = _OPTIONS[option]
    config = _FAMILIES[family][0]()
    config["inference"].update(options)
    if options.get("remove_flow"):
        del config["flow"], config["inference"]["flow"]
    j_built = j_create_models(config, seed=SEED)["inference"]
    built = create_models(config, seed=SEED)["inference"]
    j_save_package(str(tmp_path / "jax"), config, j_built,
                   export_stablehlo=True, batch_size=batch)
    os.makedirs(tmp_path / "port")
    write_serving_spec(str(tmp_path / "port"), built.obj, built.params,
                       batch_size=batch, device="cpu")
    for name in ("step_spec.txt", "state_init.bin"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    spec = (tmp_path / "port" / "step_spec.txt").read_text()
    frame_dtype = "f32" if options.get("skip_processing") else "u8"
    h = config["inference"]["frame_height"]
    assert f"input {frame_dtype} {batch},{h},{W},3\n" in spec
