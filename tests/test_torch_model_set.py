"""The OBS model set on the Python-free backend, on the CPU:
``joshupscale_torch.tools.make_model_set`` writing each tier's
``step.pt2`` set (``--cpu``), held against ``Engine`` and against the
reference tool's serving files, served through the fake OBS host, and
the port's host installed, relocated and packed.

Two tiers at their widths with 1 res block a net, f32: ``model_psp``
(flow-resnet 64, generator 64) on 16x24 frames and ``model_ps2`` (the
flow autoencoder 32...256, brightness, generator 64) on 15x24 frames,
which pad to 16x24 (the ``last_frames`` leaf is the padded frame, as
270 rows pad to 272 on the card).  One ``make_model_set`` run exports
both, one after the other in this process; torch runs on one thread,
as the host does (``tests/test_torch_native.py``).  The host is the
build of ``joshupscale_torch.native.build()``, which
``tests/test_torch_native.py`` shares.
"""

import os
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from _torch_parity import u8_frames
from joshupscale_torch import native
from joshupscale_torch.export.package import (
    export_step,
    load_aoti_step,
    load_package,
    state_leaves,
)
from joshupscale_torch.tools import make_model_set
from test_native import _host_pattern, _masked_compose
from test_torch_native import _engine_bytes, _env

REPO = Path(__file__).resolve().parent.parent
TIERS = {"model_psp": (16, 24), "model_ps2": (15, 24)}
T = 3


def _engine(path, frames):
    """``Engine``'s frames for the package at ``path`` (one thread)."""
    model, params = load_package(str(path))
    return _engine_bytes(SimpleNamespace(obj=model, params=params), frames)


def _tier_config(name, h, w):
    """The tier's config file with 1 res block a net, ``h`` x ``w``
    frames and f32."""
    with open(REPO / make_model_set.MODEL_CONFIGS[name]) as f:
        doc = yaml.safe_load(f)
    models = doc["models"]
    for net in models.values():
        if "num_res_blocks" in net:
            net["num_res_blocks"] = 1
    models["inference"].update(frame_height=h, frame_width=w,
                               compute_dtype="float32")
    return doc


@pytest.fixture(scope="module")
def model_set(tmp_path_factory):
    """The port's set of the two tiers (``make_model_set --cpu``) and the
    reference tool's (``tools/make_model_set.py``, in process, with its
    serving set, on the CPU) from the same config files."""
    from tools.make_model_set import build_model_set as j_build_model_set

    root = tmp_path_factory.mktemp("model_set")
    configs = {}
    for name, (h, w) in TIERS.items():
        path = root / f"{name}.yaml"
        path.write_text(yaml.safe_dump(_tier_config(name, h, w)))
        configs[name] = str(path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert make_model_set.main(
            ["--out", str(root / "port"), "--cpu", "--models", *TIERS,
             *(a for n, p in configs.items() for a in ("--config",
                                                       f"{n}={p}"))]) == 0
    finally:
        torch.set_num_threads(threads)
    j_build_model_set(str(root / "jax"), models=list(TIERS),
                      configs=configs, stablehlo=True)
    return root


def test_model_set_serving_files_match_reference_tool(model_set):
    """Each tier's package holds the Python-free set, and its
    ``step_spec.txt`` and ``state_init.bin`` are byte for byte the
    reference tool's (the PS2 tier's first state leaf is the padded
    frame)."""
    for name in TIERS:
        port = model_set / "port" / name
        assert {"model.yaml", "params.npz", "step.pt2", "step_spec.txt",
                "state_init.bin"} <= set(os.listdir(port)), name
        for f in ("step_spec.txt", "state_init.bin"):
            assert ((port / f).read_bytes()
                    == (model_set / "jax" / name / f).read_bytes()), (name, f)
    assert "input f32 1,16,24,3" in (
        model_set / "port" / "model_ps2" / "step_spec.txt").read_text()
    assert (model_set / "port" / "mask.png").exists()


@pytest.mark.parametrize("name", list(TIERS))
def test_model_set_step_matches_engine(model_set, name):
    """Each tier's ``step.pt2`` through ``load_aoti_step`` gives
    ``Engine``'s bytes, over recurrent frames, bit for bit (f32, one
    thread); ``model_ps2`` was exported second in the process that wrote
    ``model_psp`` first."""
    path = str(model_set / "port" / name)
    model, _ = load_package(path)
    h, w = TIERS[name]
    frames = u8_frames(np.random.default_rng(7), T, h, w)
    ref = _engine(path, frames)
    step = load_aoti_step(path)
    state = state_leaves(model.init_state(1, device="cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t, frame in enumerate(frames):
            out, *state = step(torch.from_numpy(frame[None]), *state)
            np.testing.assert_array_equal(out[0].numpy(), ref[t])
    finally:
        torch.set_num_threads(threads)


def test_export_starts_from_a_cleared_dispatch_cache(model_set):
    """The guard of two exports in one process: ``export_step`` traces
    from an empty fake-tensor dispatch cache, so an entry that an earlier
    trace left is gone once it has run.  On the card an export after
    another one of the same architecture came out off ``Engine`` from
    frame 0 until the cache was cleared (``ROADMAP.md`` section 3,
    ``tools/export_isolation.py``); on the CPU the second export above
    (``model_ps2``) matches bit for bit either way."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = set(FakeTensorMode.cache)
    with FakeTensorMode():
        torch.empty(7, 3, 5) * 2
    left = set(FakeTensorMode.cache) - before
    assert left
    model, params = load_package(str(model_set / "port" / "model_psp"))
    export_step(model, params, device="cpu")
    assert not left & set(FakeTensorMode.cache)


@pytest.fixture(scope="module")
def host():
    return native.build()


def test_fake_obs_host_over_the_model_set(host, model_set, tmp_path):
    """The OBS filter shim runs over the written set with the Python-free
    backend (``JOSHUPSCALE_TORCH_AOTI=1``, the CPU named): ``model_psp``
    presents ``Engine``'s bytes for two recurrent frames, the swap to
    ``model_ps2`` presents the masked HUD compose of ``Engine``'s frame
    with the set's own ``mask.png``, and after the missing
    ``model_ps2_fast`` the recovered ``model_ps2`` presents it again."""
    from PIL import Image

    data = model_set / "port"
    out = tmp_path / "out"
    out.mkdir()
    result = subprocess.run([str(host / "fake_obs_host"), str(data),
                             str(out)], env=_env(JOSHUPSCALE_TORCH_AOTI="1"),
                            capture_output=True, text=True, timeout=180)
    assert result.returncode == 0, result.stderr[-4000:]
    assert "fake obs host OK" in result.stdout
    assert "AOTInductor engine loaded" in result.stderr

    def presented(name, h, w):
        raw = np.fromfile(out / name, np.uint8)
        return raw.reshape(4 * h, 4 * w, 4)[:, :, :3]  # BGRX -> BGR

    h, w = TIERS["model_psp"]
    pattern = _host_pattern(h, w)
    ref = _engine(data / "model_psp", [pattern, pattern])
    np.testing.assert_array_equal(presented("psp_0.raw", h, w), ref[0])
    np.testing.assert_array_equal(presented("psp_1.raw", h, w), ref[1])
    h, w = TIERS["model_ps2"]
    pattern = _host_pattern(h, w)
    mask = np.asarray(Image.open(data / "mask.png"))
    expect = _masked_compose(_engine(data / "model_ps2", [pattern])[0],
                             pattern, mask)
    np.testing.assert_array_equal(presented("ps2_0.raw", h, w), expect)
    np.testing.assert_array_equal(presented("ps2_recovered.raw", h, w),
                                  expect)


_CONSUMER_CMAKE = """cmake_minimum_required(VERSION 3.18)
project(consumer CXX)
set(CMAKE_CXX_STANDARD 17)
find_package(JoshUpscale REQUIRED)
add_executable(consumer main.cc)
target_link_libraries(consumer PRIVATE JoshUpscale::core)
"""
_CONSUMER_MAIN = """#include <joshupscale/core.h>
int main() { return JoshUpscale::core::createRuntime != nullptr ? 0 : 1; }
"""


def test_installed_host_serves_a_package_relocated(host, model_set,
                                                   tmp_path):
    """``cmake --install`` of the port's host, then the prefix moved
    elsewhere: a downstream project builds against it with
    ``find_package(JoshUpscale)`` + ``JoshUpscale::core`` and runs, and
    the installed ``upscale_cli`` serves ``model_psp``'s ``step.pt2``
    with ``Engine``'s bytes while loading nothing from the build trees
    (the dynamic loader's own log): the op library comes from the
    prefix's ``lib/``.  The counterpart of ``tests/test_native.py``'s
    ``test_cmake_package_export``."""
    prefix = tmp_path / "prefix"
    with native.locked():
        subprocess.run(["cmake", "--install", str(host), "--prefix",
                        str(prefix)], check=True, capture_output=True)
    moved = tmp_path / "moved"
    prefix.rename(moved)
    assert (moved / "lib" / "cmake" / "JoshUpscale"
            / "JoshUpscaleConfig.cmake").exists()

    consumer = tmp_path / "consumer"
    consumer.mkdir()
    (consumer / "CMakeLists.txt").write_text(_CONSUMER_CMAKE)
    (consumer / "main.cc").write_text(_CONSUMER_MAIN)
    build = consumer / "build"
    for cmd in (["cmake", "-S", str(consumer), "-B", str(build),
                 f"-DCMAKE_PREFIX_PATH={moved}"],
                ["cmake", "--build", str(build)]):
        subprocess.run(cmd, check=True, capture_output=True)
    assert subprocess.run([str(build / "consumer")], env=_env(),
                          timeout=120).returncode == 0

    h, w = TIERS["model_psp"]
    frames = u8_frames(np.random.default_rng(3), 2, h, w)
    frames.tofile(tmp_path / "in.raw")
    result = subprocess.run(
        [str(moved / "bin" / "upscale_cli"), str(model_set / "port"
                                                 / "model_psp"),
         str(tmp_path / "in.raw"), str(tmp_path / "out.raw")],
        env=_env(JOSHUPSCALE_TORCH_AOTI="1", LD_DEBUG="files"),
        capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-4000:]
    loaded = [os.path.normpath(line.split("calling init:", 1)[1].strip())
              for line in result.stderr.splitlines()
              if "calling init:" in line]
    assert any(p.startswith(str(moved / "lib" / "libjoshupscale_ops-"))
               for p in loaded), loaded
    build_trees = str(REPO / "joshupscale_torch" / "_build")
    assert not [p for p in loaded if p.startswith(build_trees)], loaded
    out = np.fromfile(tmp_path / "out.raw", np.uint8).reshape(
        (2, 4 * h, 4 * w, 3))
    np.testing.assert_array_equal(
        out, _engine(model_set / "port" / "model_psp", frames))


def test_cpack_end_user_packages(host, tmp_path):
    """``cpack`` writes the port's runtime / development pair:
    Runtime = the library, its op library and ``upscale_cli``;
    Development = the headers and the ``find_package`` export; on Debian
    also the DEB pair, the dev package pinned to the runtime's version.
    The counterpart of ``tests/test_native.py``'s
    ``test_cpack_end_user_packages``."""
    out = tmp_path / "pkg"
    with native.locked():
        subprocess.run(["cpack", "-B", str(out)], cwd=host, check=True,
                       capture_output=True, timeout=300)
    archives = {p.name for p in out.iterdir() if p.is_file()}
    runtime = "joshupscale-torch-1.0.0-Linux-Runtime.tar.gz"
    development = "joshupscale-torch-1.0.0-Linux-Development.tar.gz"
    assert {runtime, development} <= archives, archives
    with tarfile.open(out / runtime) as tf:
        names = tf.getnames()
    assert any(n.endswith("lib/libjoshupscale_torch.so") for n in names)
    assert any("lib/libjoshupscale_ops-" in n for n in names)
    assert any(n.endswith("bin/upscale_cli") for n in names)
    with tarfile.open(out / development) as tf:
        names = tf.getnames()
    assert any(n.endswith("include/joshupscale/core.h") for n in names)
    assert any(n.endswith("JoshUpscaleConfig.cmake") for n in names)
    if os.path.exists("/etc/debian_version") and shutil.which("dpkg-deb"):
        debs = sorted(n for n in archives if n.endswith(".deb"))
        arch = subprocess.run(["dpkg", "--print-architecture"],
                              capture_output=True, text=True).stdout.strip()
        assert debs == [f"joshupscale-torch-dev_1.0.0_{arch}.deb",
                        f"joshupscale-torch_1.0.0_{arch}.deb"]
        info = subprocess.run(["dpkg-deb", "-I", str(out / debs[0])],
                              check=True, capture_output=True,
                              text=True).stdout
        assert "Depends: joshupscale-torch (= 1.0.0)" in info
