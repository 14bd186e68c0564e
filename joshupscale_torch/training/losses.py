"""Loss terms of FRVSR training (port of the FRVSR subset of
``joshupscale_tpu/training/losses.py``): computed in float32, whatever
the compute dtype."""

from __future__ import annotations

import torch

# Non-trainable leaves: batch-norm moving statistics and the fade-in
# schedule.  The l2 penalty skips them, as the reference regularizes
# trainable variables only, and the trainers never give them gradients.
NON_TRAINABLE_KEYS = frozenset(
    ("moving_mean", "moving_variance", "counter", "period"))


def channel_sum_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Squared difference summed over channels, mean over the rest."""
    return torch.square(pred.float() - target.float()).sum(-1).mean()


def trainable_leaves(params, path: str = ""):
    """``(dotted path, tensor)`` of every float leaf outside
    ``NON_TRAINABLE_KEYS``, in the tree's order."""
    for k, v in params.items():
        sub = f"{path}.{k}" if path else str(k)
        if isinstance(v, dict):
            yield from trainable_leaves(v, sub)
        elif k not in NON_TRAINABLE_KEYS and v.is_floating_point():
            yield sub, v


def l2_regularization(params, scale: float) -> torch.Tensor:
    """Keras-style l2 penalty: ``scale`` times the sum of squares of the
    trainable leaves."""
    return scale * sum(torch.square(v.float()).sum()
                       for _, v in trainable_leaves(params))
