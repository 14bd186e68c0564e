"""The traffic generator, the weights and the check's sample repeat
exactly from a seed."""

from __future__ import annotations

import json

import numpy as np
import torch

from benchlib import check
from benchlib.traffic import make_ring
from benchlib.weights import seeded_params
from bench_helpers import BENCH, tiny_config, tiny_mix

SEED = 2**31 + 977  # past 32 signed bits, as a run's seed may be


def test_ring_repeats_from_seed():
    mix = tiny_mix("batch4")
    a = make_ring(mix, SEED, 30, 48, "cpu")
    b = make_ring(mix, SEED, 30, 48, "cpu")
    c = make_ring(mix, SEED + 1, 30, 48, "cpu")
    assert a.shape == (16, 4, 30, 48, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # four streams of their own, with texture (not flat)
    assert not np.array_equal(a[:, 0], a[:, 1])
    assert a.std() > 30


def test_ring_pans_and_loops():
    """With a whole-pixel pan, frame t + 1 is frame t moved by the pan,
    and the ring's last frame leads into its first."""
    mix = dict(tiny_mix("stream"), pan_lr_px_per_frame=[0.0, 2.0])
    ring = make_ring(mix, SEED, 30, 48, "cpu")[:, 0].astype(int)
    for t in range(len(ring)):
        nxt = ring[(t + 1) % len(ring)]
        moved = np.abs(nxt[:, 2:] - ring[t][:, :-2])
        assert moved.max() <= 1 and (moved > 0).mean() < 0.01


def test_weights_repeat_from_seed():
    from joshupscale_torch.models.registry import create_models, strip_meta

    cfg = tiny_config("quality")
    models = cfg["models"]
    template = strip_meta(create_models(models, seed=0)["inference"].params)

    def flat(seed):
        tree = seeded_params(template, models, cfg["weights"], [2.0, 8.0],
                             seed, "cpu")
        out = []

        def walk(t):
            for k in sorted(t):
                walk(t[k]) if isinstance(t[k], dict) else out.append(
                    t[k].reshape(-1))
        walk(tree)
        return torch.cat(out), tree

    a, tree = flat(SEED)
    b, _ = flat(SEED)
    c, _ = flat(SEED + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    head = tree["flow"]["conv_2"]["bias"].view(-1, 2)
    assert torch.all(head[:, 0] == 2.0) and torch.all(head[:, 1] == 8.0)
    gamma = tree["generator"]["block_1"]["bn_2"]["gamma"]
    assert torch.allclose(gamma, torch.full_like(gamma, 0.2))
    assert torch.all(tree["generator"]["bn_1"]["gamma"] == 1.0)


def test_kept_calls_from_seed():
    mix = json.loads((BENCH / "traffic" / "stream.json").read_text())
    a = check.kept_calls(mix, SEED)
    assert a == check.kept_calls(mix, SEED)
    shot = mix["shot_frames"]
    shots = sorted({c // shot for c in a})
    first = mix["check"]["first_shot"]
    assert len(shots) == mix["check"]["shots"]
    assert all(first <= k < first + mix["check"]["shots_among"]
               for k in shots)
    # the traced stretch holds no kept call
    assert min(a) >= mix["trace_calls"]
    # every shot's last frame, the longest recurrence, is kept
    assert all(k * shot + shot - 1 in a for k in shots)
    assert sorted(a.values()) == list(range(len(a)))
