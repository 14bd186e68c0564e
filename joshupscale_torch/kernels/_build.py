"""Build the CUDA sources under ``joshupscale_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, at first use, into
``joshupscale_torch/_build/`` (git-ignored), then loaded with ``ctypes``.
The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and concurrent builders never share a partial file.  All sources are compiled in parallel (one ``nvcc`` each).

``csrc/torch_ops.cpp`` registers K1 and K2 as torch ops
(``torch.ops.joshupscale``); ``build_ops`` compiles it with the host
compiler against the installed torch (its headers, libraries and C++
ABI) and links it to the two kernels' libraries, and ``ops`` loads it.
Against a torch without CUDA it registers the schemas and the Meta
implementations only.

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

OPS_SOURCE = CSRC / "torch_ops.cpp"
OPS_KERNELS = ("resblock_conv", "display_u8")  # what the ops launch

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_OPS_LOADED = False
_HOST_CXX = None


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
        out[name] = ptxas_rows(log, _demangle(log, nvcc))
    return out


def ptxas_rows(log: str, short: Dict[str, str]) -> list:
    """[(kernel, registers, spilled bytes, notes)] of ``ptxas -v``'s
    ``log``, each entry function by its name in ``short`` (an
    ``extern "C"`` name, which is not mangled, by itself)."""
    notes: Dict[str, list] = {}
    for m in re.finditer(
            r"\((C\d+)\) ([^\n]*?) (?:in|for) (?:the )?function '(\w+)'",
            log):
        notes.setdefault(short.get(m.group(3), m.group(3)), []).append(
            f"{m.group(1)} {m.group(2)}")
    rows, kernel, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, spill = short.get(m.group(1), m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spill,
                         notes.get(kernel, [])))
    return rows


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


def _torch_flags() -> list:
    """Host-compiler flags for a unit built against the installed torch:
    its include directories and its C++ ABI (plus CUDA's headers and
    ``JOSHUPSCALE_OPS_CUDA`` where torch has CUDA)."""
    import torch

    inc = Path(torch.__file__).resolve().parent / "include"
    flags = ["-std=c++17", "-O2", "-fPIC",
             "-D_GLIBCXX_USE_CXX11_ABI="
             f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             "-isystem", str(inc),
             "-isystem", str(inc / "torch" / "csrc" / "api" / "include")]
    if torch.version.cuda:
        cuda_inc = Path(find_nvcc()).resolve().parent.parent / "include"
        flags += ["-isystem", str(cuda_inc), "-DJOSHUPSCALE_OPS_CUDA"]
    return flags


def _torch_libs() -> list:
    """Linker flags for the installed torch's libraries."""
    import torch

    lib = Path(torch.__file__).resolve().parent / "lib"
    libs = ["-L", str(lib), f"-Wl,-rpath,{lib}", "-lc10", "-ltorch",
            "-ltorch_cpu"]
    if torch.version.cuda:
        libs += ["-lc10_cuda", "-ltorch_cuda"]
    return libs


def ops_path() -> Path:
    """The op library; its name hashes the source, the compiler and its
    flags, torch's version and the kernels' libraries it links."""
    import torch

    kernels = [_lib_path(n).name for n in OPS_KERNELS] if torch.version.cuda \
        else []
    digest = hashlib.sha1(OPS_SOURCE.read_bytes())
    digest.update(" ".join([host_cxx()] + _torch_flags() + kernels).encode())
    digest.update(torch.__version__.encode())
    return BUILD_DIR / f"libjoshupscale_ops-{digest.hexdigest()[:12]}.so"


def build_ops(also: Iterable[str] = ()) -> Path:
    """Build the op library if it is not up to date and return its path.

    The unit compiles while ``nvcc`` builds the two kernels' libraries
    (with a CUDA torch), then links against them (``DT_NEEDED`` by name,
    found through ``$ORIGIN``).  ``also`` names more ``csrc/*.cu``
    sources for the same ``nvcc`` batch.  A failed build raises."""
    import torch

    out = ops_path()
    if out.exists():
        if torch.version.cuda:
            build_all(also)
        return out
    cxx = host_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = out.with_suffix(f".{os.getpid()}.o")
    compile_ = subprocess.Popen(
        [cxx, *_torch_flags(), "-c", str(OPS_SOURCE), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    kernels = []
    try:
        if torch.version.cuda:
            build_all(sorted(set(OPS_KERNELS) | set(also)))
            kernels = ["-L", str(BUILD_DIR), "-Wl,-rpath,$ORIGIN",
                       *(f"-l:{_lib_path(n).name}" for n in OPS_KERNELS)]
    finally:
        log, _ = compile_.communicate()
    if compile_.returncode != 0:
        obj.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for torch_ops.cpp (exit "
                           f"{compile_.returncode}):\n{log.decode()}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [cxx, "-shared", "-o", str(tmp), str(obj), *kernels, *_torch_libs()],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    obj.unlink(missing_ok=True)
    if link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"linking the op library failed (exit "
                           f"{link.returncode}):\n{link.stdout.decode()}")
    os.replace(tmp, out)
    return out


def ops():
    """``torch.ops.joshupscale``, with the op library built and loaded."""
    global _OPS_LOADED
    import torch

    with _LOCK:
        if not _OPS_LOADED:
            torch.ops.load_library(str(build_ops()))
            _OPS_LOADED = True
    return torch.ops.joshupscale


def host_cxx() -> str:
    """The host C++ compiler of everything the port builds besides the
    kernels (the op library, the C++ host, AOTInductor's packages): the
    first of ``CXX``, ``g++``, ``c++`` that compiles and links an OpenMP
    program.  AOTInductor builds a package's host code with
    ``-fopenmp``, and a compiler without its OpenMP runtime fails there;
    one compiler for all keeps one C++ runtime in the process.  Raises
    when none does."""
    global _HOST_CXX
    if _HOST_CXX is None:
        import tempfile

        probe = ("#include <omp.h>\n"
                 "int main() { return omp_get_max_threads() > 0 ? 0 : 1; }\n")
        tried = []
        for cxx in (os.environ.get("CXX"), "g++", "c++"):
            path = shutil.which(cxx) if cxx else None
            if path is None or path in tried:
                continue
            tried.append(path)
            with tempfile.TemporaryDirectory() as tmp:
                src = os.path.join(tmp, "probe.cpp")
                with open(src, "w") as f:
                    f.write(probe)
                ok = subprocess.run(
                    [path, "-fopenmp", src, "-o", os.path.join(tmp, "probe")],
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL).returncode == 0
            if ok:
                _HOST_CXX = path
                break
        if _HOST_CXX is None:
            raise RuntimeError(f"no C++ compiler links OpenMP programs "
                               f"(tried {tried}); the op library and "
                               f"AOTInductor need one")
    return _HOST_CXX


def tracing(t) -> bool:
    """Whether ``t`` comes out of a trace (``torch.export``'s fake
    tensors), where an op launches no kernel."""
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)
