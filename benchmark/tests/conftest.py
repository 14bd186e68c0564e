"""Fixtures of the benchmark's CPU tests: the harness on the path, tiny
checkouts, the card where there is one."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent), str(HERE.parent.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench_helpers import make_root  # noqa: E402

# The runs here are tiny: a few threads a test process keeps several
# test workers from starving each other.
torch.set_num_threads(2)


@pytest.fixture()
def tiny_root(tmp_path):
    return make_root(tmp_path, [("quality.stream", "quality", "stream"),
                                ("ps2_style.stream", "ps2_style", "stream"),
                                ("quality.batch4", "quality", "batch4")])


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
