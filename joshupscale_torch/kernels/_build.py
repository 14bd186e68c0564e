"""Build the CUDA sources under ``joshupscale_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, at first use, into
``joshupscale_torch/_build/`` (git-ignored), then loaded with ``ctypes``.
The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and concurrent builders never share a partial file.  All sources are compiled in parallel (one ``nvcc`` each).

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC", "-lineinfo"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME, or put nvcc on PATH); "
        "the CUDA kernels of joshupscale_torch are built with it at "
        "first use")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``; its name hashes the source,
    every shared header ``csrc/*.cuh`` and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = None) -> None:
    """Compile every named source (default: all of ``csrc/*.cu``) that
    has no up-to-date library, all ``nvcc`` processes at once."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    missing = [(n, _lib_path(n)) for n in names
               if not _lib_path(n).exists()]
    if not missing:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in missing:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.

    Every library exports ``jt_error_string(int) -> const char*``.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.jt_error_string.argtypes = [ctypes.c_int]
            lib.jt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.jt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
