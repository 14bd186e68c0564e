"""The C++ host over the port: a CMake project (``CMakeLists.txt``).

``build()`` configures and builds it at first use into the git-ignored
``joshupscale_torch/_build/native/`` and returns that directory, which
then holds ``libjoshupscale_torch.so`` (the C and C++ ABI of
``native/include/joshupscale/``), ``upscale_cli``, ``fake_obs_host``,
``fake_avisynth_host`` and the shims' stub-check modules.  Configuring
builds the op library (``kernels._build.build_ops``).  A failed step
raises.  From a shell: ``python -m joshupscale_torch.native``.

The host picks its backend and device from the environment:

- ``JOSHUPSCALE_TORCH_AOTI=1``: the Python-free backend, which runs the
  package's ``step.pt2`` (``save_package(..., export_aoti=True)``) and
  raises without it; otherwise the embedded-Python backend
  (``runtime.native_glue.NativeEngine``), which serves any package.
- ``JOSHUPSCALE_TORCH_DEVICE=cpu``: the CPU; otherwise the host's device
  id is a CUDA index, and no card is an error.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent
BUILD_DIR = SOURCE.parent / "_build" / "native"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Configure (every call: it also brings the op library up to date)
    and build the host into ``build_dir`` with ``kernels._build.host_cxx``
    (a build directory configured otherwise is started afresh), one
    process at a time; returns ``build_dir``."""
    cmake = shutil.which("cmake")
    if cmake is None:
        raise RuntimeError("cmake not found: the host over the port is a "
                           "CMake project (joshupscale_torch/native)")
    from joshupscale_torch.kernels._build import host_cxx

    with locked(build_dir):
        return _build(Path(build_dir), cmake, host_cxx())


@contextlib.contextmanager
def locked(build_dir: Path = BUILD_DIR):
    """Hold ``build_dir``'s lock: one process at a time configures,
    builds, installs or packs a tree."""
    build_dir = Path(build_dir)
    build_dir.parent.mkdir(parents=True, exist_ok=True)
    with open(build_dir.parent / f".{build_dir.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield build_dir


def _build(build_dir: Path, cmake: str, cxx: str) -> Path:
    cache = build_dir / "CMakeCache.txt"
    if cache.exists() and not all(
            re.search(rf"^{key}:\w+={re.escape(value)}$", cache.read_text(),
                      re.M) for key, value in (("CMAKE_CXX_COMPILER", cxx),
                                                ("CMAKE_COMMAND", cmake))):
        # Configured with another compiler or cmake, or on another
        # machine (a copied checkout): configure afresh.
        shutil.rmtree(build_dir)
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    for cmd in ([cmake, "-S", str(SOURCE), "-B", str(build_dir), *gen,
                 f"-DCMAKE_CXX_COMPILER={cxx}",
                 f"-DPython3_EXECUTABLE={sys.executable}"],
                [cmake, "--build", str(build_dir), "--parallel",
                 str(os.cpu_count() or 4)]):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout[-8000:]}")
    return build_dir
