"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; every file the run needs is found by those names (see
``benchmark/README.md``).  The seed makes the weights and the frames.
``--trace 0`` prints the end-to-end metrics, ``--trace 1`` the per-layer
ones read from a profiler session over the window's first calls.  The
last line of standard output is one JSON object; the last lines of
standard error are the numbers the check compared, each beside its
limit.  Without a CUDA device, or with fewer than the cell asks for, the
run exits 2 and prints no result; if JAX or the JAX package was loaded,
it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "joshupscale_tpu")


def process_start() -> float:
    """The process's start on ``time.monotonic``'s clock (to 10 ms, from
    /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_START = process_start()


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its own kernels into ``joshupscale_torch/_build``)."""
    base = root / ".bench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor")}


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(cache_env(ROOT))
    sys.path[:0] = [str(HERE), str(ROOT)]
    from benchlib.trace import CUPTI_ENV

    if args.trace:
        os.environ.update(CUPTI_ENV)
    import torch

    from benchlib.runner import log, run_cell
    from benchlib.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"run: {args.workload} needs {cell.chips} CUDA device(s); "
            f"{have} available")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START,
                      kind=torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        log(f"run: modules of JAX or the JAX package were loaded: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
