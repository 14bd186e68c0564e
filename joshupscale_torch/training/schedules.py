"""Learning-rate schedules (port of
``joshupscale_tpu/training/schedules.py``): constant, exponential decay
and piecewise constant, as ``step -> learning rate`` in float32, the
rounding of the reference's optax schedules."""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import numpy as np


def get_learning_rate(lr: Union[float, Dict[str, Any]]
                      ) -> Union[float, Callable[[int], float]]:
    """A config value -> a float or a schedule ``f(step)``; ``step`` is
    the count of optimizer steps taken before this one."""
    if isinstance(lr, (int, float)):
        return float(lr)
    if not isinstance(lr, dict):
        raise TypeError(f"Unknown learning rate config: {lr!r}")
    name = lr.get("name")
    if name == "constant":
        return float(lr["value"])
    if name == "exponential":
        # Keras ExponentialDecay(initial_learning_rate, decay_steps,
        # decay_rate, staircase), as optax.exponential_decay computes it.
        init = np.float32(lr["initial_learning_rate"])
        steps = np.float32(int(lr["decay_steps"]))
        rate = np.float32(lr["decay_rate"])
        staircase = bool(lr.get("staircase", False))

        def exponential(step: int) -> float:
            p = np.float32(step) / steps
            if staircase:
                p = np.floor(p)
            return float(init * rate ** p)

        return exponential
    if name == "piecewise":
        # Keras PiecewiseConstantDecay: values[0] holds while step <=
        # boundaries[0] (inclusive), so the value changes at boundary + 1.
        boundaries = [int(b) + 1 for b in lr["boundaries"]]
        values = [float(np.float32(v)) for v in lr["values"]]

        def piecewise(step: int) -> float:
            return values[sum(step >= b for b in boundaries)]

        return piecewise
    raise ValueError(f"Unknown learning rate type: {name}")
