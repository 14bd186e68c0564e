"""Loss terms of FRVSR and TecoGAN training (port of
``joshupscale_tpu/training/losses.py``): computed in float32, whatever
the compute dtype.

Two forms follow the reference's arithmetic rather than torch's
library calls: the sigmoid cross-entropy is ``max(x, 0) + log1p(exp(-
|x|))`` (``F.softplus`` switches to ``x`` past a threshold), and the
VGG loss normalizes as ``x * rsqrt(max(sum(x^2), 1e-7))``, the epsilon
clamping the squared norm (``F.normalize`` clamps the norm, about 3x
apart on near-zero rows).

Under the data-parallel mesh (``parallel.mesh``: equal shards of the
global batch), the ranks' mean loss is the global batch's loss, and so
the all-reduced mean of the ranks' gradients is its gradient, because
every term is one of two kinds:
- a mean over per-sample quantities, each sample counted alike:
  ``channel_sum_mse`` (a mean over batch, time and pixels), the
  sigmoid cross-entropy terms (``adversarial_loss``,
  ``discr_fake_loss``, ``discr_real_loss``: means over the logits),
  ``feature_matching_loss`` and ``vgg_cosine_loss`` (means per layer,
  weighted by constants) and ``ping_pong_loss`` (a sum over the batch
  divided by a count that grows with the batch);
- a param-only term, ``l2_regularization``: the same on every rank,
  so the mean counts it once.
The GAN's gate on the adversarial term reads the EMAs, which every
rank holds alike.  Batch norm, the one coupling between samples, takes
its moments over the global batch (``nn.layers.batch_norm_train``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

EPSILON = 1e-7  # keras.config.epsilon()

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


def ping_pong_loss(gen_outputs: torch.Tensor) -> torch.Tensor:
    """L1 between the forward frames and the mirrored tail of a
    (B, 2T-1, ...) ping-pong run: ``|x - flip(x)|`` over the whole
    sequence (symmetric about the pivot frame, whose term is 0), summed
    and divided by the 2(T-1) frame slots' elements."""
    x = gen_outputs.float()
    n = x.shape[1]
    diff = torch.abs(x - torch.flip(x, dims=(1,)))
    return diff.sum() / (diff.numel() // n * (n - 1))


def sigmoid_crossentropy(logits: torch.Tensor) -> torch.Tensor:
    """``-log(sigmoid(-x))`` elementwise, as ``max(x, 0) +
    log1p(exp(-|x|))``, with the reference's gradients at x = 0: the
    max splits a tie (``torch.maximum``, not ``clamp``) and ``|x|``
    has slope 1 there (JAX's, where ``torch.abs`` has 0), so the sum's
    gradient is 0.5 - 0.5 = 0."""
    x = logits.float()
    abs_x = torch.where(x >= 0, x, -x)
    return (torch.maximum(x, torch.zeros((), device=x.device))
            + torch.log1p(torch.exp(-abs_x)))


def adversarial_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Generator adversarial term: ``-log(sigmoid(fake))``."""
    x = fake_logits.float()
    return (sigmoid_crossentropy(x) - x).mean()


def discr_fake_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Discriminator fake term: ``-log(1 - sigmoid(fake))``."""
    return sigmoid_crossentropy(fake_logits).mean()


def discr_real_loss(real_logits: torch.Tensor) -> torch.Tensor:
    """Discriminator real term: ``-log(sigmoid(real))``."""
    x = real_logits.float()
    return (sigmoid_crossentropy(x) - x).mean()


def feature_matching_loss(real_layers: Sequence[torch.Tensor],
                          fake_layers: Sequence[torch.Tensor],
                          norms: Sequence[float]) -> torch.Tensor:
    """Per layer: L1 summed over channels, mean over the rest, divided
    by the layer's norm; summed over the layers."""
    total = 0.0
    for real, fake, norm in zip(real_layers, fake_layers, norms):
        layer = torch.abs(real.float() - fake.float()).sum(-1).mean()
        total = total + layer / norm
    return total


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``tf.math.l2_normalize(x, epsilon=1e-7)`` over the last axis."""
    eps = torch.full((), EPSILON, device=x.device)
    return x * torch.rsqrt(torch.maximum(
        torch.square(x).sum(-1, keepdim=True), eps))


def vgg_cosine_loss(real_feats: Sequence[torch.Tensor],
                    fake_feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over the layers of ``1 - mean cosine similarity`` of the
    feature vectors."""
    total = 0.0
    for real, fake in zip(real_feats, fake_feats):
        cos = (_l2_normalize(real.float())
               * _l2_normalize(fake.float())).sum(-1)
        total = total + (1.0 - cos.mean())
    return total


DEFAULT_GAN_LOSS_CONFIG: Dict[str, object] = {
    # The reference's GANModel._get_loss_config.
    "content_loss": 1.0,
    "pp_loss": 0.5,
    "warp_loss": 1.0,
    "adv_loss": 0.1,
    "discr_layer_norms": [12.0, 14.0, 48.0, 250.0],
    "discr_layer_loss": 0.2,
    "vgg_loss": 0.2,
    "discr_real_loss": 1.0,
    "discr_fake_loss": 1.0,
    "t_balance1_threshold": 0.2,
    "t_balance2_threshold": 0.0,
}


def get_gan_loss_config(
        loss_config: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """``DEFAULT_GAN_LOSS_CONFIG`` updated with ``loss_config``."""
    cfg = dict(DEFAULT_GAN_LOSS_CONFIG)
    if isinstance(loss_config, dict):
        cfg.update(loss_config)
    return cfg
