"""On the card: a short run of each cell is correct and reports every
metric the cell names (skips where there is no card)."""

from __future__ import annotations

import time

import pytest
import torch

from bench_helpers import ROOT
from benchlib.runner import run_cell
from benchlib.spec import load_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["quality.stream", "ps2_style.stream"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_card(cuda_device, cell_name, trace):
    cell = load_cell(ROOT, cell_name)
    res = run_cell(cell, 2**31 + 77, 1.0, trace, cuda_device,
                   time.monotonic(), kind=torch.cuda.get_device_name(0))
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
    want = set(cell.per_layer) if trace else {
        m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == want
