"""What decides ``correct`` fails what it has to: the control (the plain
reference put in the program's place and computed through float8 e4m3,
the precision below the configuration's bfloat16), and a run whose timed
path is broken underneath, once for each fault a serving cell can have.
The exchange between chips is no fault of these one-chip cells."""

from __future__ import annotations

import pytest
import torch

from bench_helpers import make_root
from benchlib import check
from benchlib.runner import program, run_cell
from benchlib.spec import load_cell
from benchlib.traffic import make_ring
from benchlib.weights import seeded_params

SEED = 2**31 + 1234


@pytest.fixture()
def root(tmp_path):
    return make_root(tmp_path, [("quality.stream", "quality", "stream"),
                                ("ps2_style.stream", "ps2_style", "stream"),
                                ("quality.batch4", "quality", "batch4")])


@pytest.mark.parametrize("cell_name", ["quality.stream", "ps2_style.stream"])
def test_sound_run_is_correct(root, cell_name):
    res = run_cell(load_cell(root, cell_name), SEED, 0.3, False, "cpu", 0.0)
    assert res["correct"] and res["failed"] == 0


@pytest.mark.parametrize("cell_name", ["quality.stream", "ps2_style.stream"])
def test_control_fails(root, cell_name):
    cell = load_cell(root, cell_name)
    mix, models = cell.traffic, cell.config["models"]
    inf = models["inference"]
    pan = [4 * v for v in mix["pan_lr_px_per_frame"]]
    params = seeded_params(program(cell)[1], models,
                           cell.config["weights"], pan, SEED, "cpu")
    ring = make_ring(mix, SEED, inf["frame_height"], inf["frame_width"],
                     "cpu")
    kept = check.kept_calls(mix, SEED)
    served, _ = check.reference_frames(cell.reference, models, params, ring,
                                    mix, kept, "cpu",
                                    rounding=torch.float8_e4m3fn)
    numbers, _ = check.compare(cell.reference, models, params, ring, mix,
                               kept, served, "cpu")
    correct, compared = check.judge(numbers, cell.limits)
    assert not correct
    assert all(v > lim for v, lim in compared.values())


def test_state_left_unchanged_fails(root, monkeypatch):
    import joshupscale_torch.runtime.engine as engine

    monkeypatch.setattr(engine, "commit_state", lambda state, new: None)
    res = run_cell(load_cell(root, "quality.stream"), SEED, 0.3, False,
                   "cpu", 0.0)
    assert not res["correct"]


def test_half_the_batch_left_out_fails(root, monkeypatch):
    from joshupscale_torch.parallel.serving import ShardedEngine

    served = ShardedEngine.process

    def half(self, frames):
        out = served(self, frames)
        out[len(out) // 2:] = out[:len(out) // 2]
        return out

    monkeypatch.setattr(ShardedEngine, "process", half)
    res = run_cell(load_cell(root, "quality.batch4"), SEED, 0.3, False,
                   "cpu", 0.0)
    assert not res["correct"]


def test_answer_altered_where_produced_fails(root, monkeypatch):
    import joshupscale_torch.runtime.engine as engine

    display = engine.d2s_display_u8
    calls = {"n": 0}

    def altered(x):
        out = display(x)
        calls["n"] += 1
        if calls["n"] % 2 == 0:  # every other frame, rows shifted by 8
            out = torch.roll(out, 8, dims=1)
        return out

    monkeypatch.setattr(engine, "d2s_display_u8", altered)
    res = run_cell(load_cell(root, "quality.stream"), SEED, 0.3, False,
                   "cpu", 0.0)
    assert not res["correct"]
    assert res["compared"]["worst_frame_mean_abs_u8"]["value"] > \
        res["compared"]["worst_frame_mean_abs_u8"]["limit"]
    assert res["failed"] > 0
