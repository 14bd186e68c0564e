"""The plain reference against the program at tiny sizes on the CPU, in
float32, for both flow families, over several recurrent frames."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_helpers import BENCH, TINY, tiny_config, tiny_mix
from benchlib.spec import load_module
from benchlib.traffic import make_ring
from benchlib.weights import clone, seeded_params

FRAMES = 6


@pytest.mark.parametrize("config", ["quality", "ps2_style"])
def test_reference_follows_the_program(config):
    from joshupscale_torch.models.registry import create_models, strip_meta
    from joshupscale_torch.runtime.engine import Engine

    vsr = load_module(BENCH / "reference" / "vsr.py", "test_vsr")
    cfg = tiny_config(config, dtype="float32")
    models = cfg["models"]
    built = create_models(models, seed=0)["inference"]
    params = seeded_params(strip_meta(built.params), models, cfg["weights"],
                           [2.0, 8.0], 5, "cpu")
    ring = make_ring(tiny_mix("stream"), 5, *TINY, "cpu")
    engine = Engine(built.obj, clone(params), device="cpu")
    ref = vsr.Reference(models, clone(params), "cpu")
    state = ref.init_state(1)
    worst = []
    for t in range(FRAMES):
        served = engine.process(ring[t, 0])
        display, state, flow = ref.step(torch.from_numpy(ring[t]), state)
        diff = np.abs(served.astype(int) - display[0].numpy().astype(int))
        worst.append((diff.mean(), diff.max()))
        # the flow tracks the pan (2, 8) HR pixels
        assert float(flow[..., 1].mean()) == pytest.approx(8.0, abs=1.0)
    # float32 on both sides: a u8 step only where a value sits on a
    # truncation boundary
    assert max(m for m, _ in worst) < 0.01
    assert max(x for _, x in worst) <= 1


def test_reference_state_matters():
    """The recurrence carries: a reference whose state is reset every
    frame serves other frames from the second on."""
    vsr = load_module(BENCH / "reference" / "vsr.py", "test_vsr2")
    from joshupscale_torch.models.registry import create_models, strip_meta

    cfg = tiny_config("quality", dtype="float32")
    models = cfg["models"]
    built = create_models(models, seed=0)["inference"]
    params = seeded_params(strip_meta(built.params), models, cfg["weights"],
                           [2.0, 8.0], 6, "cpu")
    ring = make_ring(tiny_mix("stream"), 6, *TINY, "cpu")
    ref = vsr.Reference(models, params, "cpu")
    state = ref.init_state(1)
    for t in range(3):
        display, state, _ = ref.step(torch.from_numpy(ring[t]), state)
        fresh, _, _ = ref.step(torch.from_numpy(ring[t]), ref.init_state(1))
        diff = (display.int() - fresh.int()).abs().float().mean()
        if t == 0:
            assert diff == 0
        else:
            assert diff > 1.0
