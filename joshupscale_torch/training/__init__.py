"""FRVSR training: trainers, losses, schedules, the step, Adam, fit.

Port of the FRVSR part of ``joshupscale_tpu/training``; the GAN trainer
waits for its slice (ROADMAP 14b).
"""

from joshupscale_torch.training.frvsr import FRVSRSingleTrainer, FRVSRTrainer
from joshupscale_torch.training.trainer import (
    Adam,
    TrainState,
    build_frvsr_step,
    fit,
    freeze_mask,
    init_train_state,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)

__all__ = [
    "Adam",
    "FRVSRSingleTrainer",
    "FRVSRTrainer",
    "TrainState",
    "build_frvsr_step",
    "fit",
    "freeze_mask",
    "init_train_state",
    "load_checkpoint",
    "make_optimizer",
    "save_checkpoint",
]
