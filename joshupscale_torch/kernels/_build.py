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
import re
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


def _demangle(log: str, nvcc: str) -> Dict[str, str]:
    """{mangled kernel name in ``log``: a short readable one}."""
    names = sorted(set(re.findall(r"_Z\w+", log)))
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not names or not os.access(filt, os.X_OK):
        return {n: n for n in names}
    lines = subprocess.run([filt, *names], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out = {}
    for n, d in zip(names, lines):
        for noise in ("(anonymous namespace)::", "<unnamed>::", "(int)",
                      "(bool)", "void "):
            d = d.replace(noise, "")
        out[n] = d.split("(")[0]
    return out


def resource_usage() -> Dict[str, list]:
    """``ptxas -v`` for every source, compiled to a throw-away cubin, all
    at once: {source: [(kernel, registers, spilled bytes, notes)]}; the
    notes are ptxas's remarks on the kernel's wgmma (an injected wait or
    fence, serialisation)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    nvcc = find_nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
         "-o", os.devnull, str(CSRC / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for n in names}
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{log}")
        short = _demangle(log, nvcc)
        notes: Dict[str, list] = {}
        for m in re.finditer(r"\((C\d+)\) ([^\n]*?) in function '(\w+)'",
                             log):
            notes.setdefault(short[m.group(3)], []).append(
                f"{m.group(1)} {m.group(2)}")
        rows, kernel, spill = [], None, 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel, spill = short[m.group(1)], 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                rows.append((kernel, int(m.group(1)), spill,
                             notes.get(kernel, [])))
        out[name] = rows
    return out


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
