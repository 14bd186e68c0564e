"""Training: FRVSR and TecoGAN trainers, losses, schedules, the steps,
Adam, checkpoints, fit, and the play callback.

Port of ``joshupscale_tpu/training``.
"""

from joshupscale_torch.training.frvsr import FRVSRSingleTrainer, FRVSRTrainer
from joshupscale_torch.training.gan import GANTrainer
from joshupscale_torch.training.play import PlayCallback, predict_sequence
from joshupscale_torch.training.trainer import (
    Adam,
    GANTrainState,
    TrainState,
    build_frvsr_step,
    build_gan_step,
    fit,
    freeze_mask,
    init_gan_state,
    init_train_state,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)

__all__ = [
    "Adam",
    "FRVSRSingleTrainer",
    "FRVSRTrainer",
    "GANTrainState",
    "GANTrainer",
    "PlayCallback",
    "TrainState",
    "build_frvsr_step",
    "build_gan_step",
    "fit",
    "freeze_mask",
    "init_gan_state",
    "init_train_state",
    "load_checkpoint",
    "make_optimizer",
    "predict_sequence",
    "save_checkpoint",
]
