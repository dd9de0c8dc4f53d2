"""Training: losses, per-parameter Adam, densification, the training loop
and checkpoints."""

from .checkpoint import load_training_state, save_training_state
from .densify import (
    DensifyConfig,
    DensifyState,
    camera_extent,
    densify_and_prune,
    reset_opacity,
    zero_densify_acc,
)
from .losses import photometric_loss, psnr, ssim, ssim_map
from .optimizer import (
    OptimizerConfig,
    make_optimizer,
    optimizer_state_from_arrays,
    position_lr_schedule,
    seed_count,
)
from .trainer import TrainConfig, Trainer, next_host_event

__all__ = [
    "DensifyConfig",
    "DensifyState",
    "OptimizerConfig",
    "TrainConfig",
    "Trainer",
    "camera_extent",
    "densify_and_prune",
    "load_training_state",
    "make_optimizer",
    "next_host_event",
    "optimizer_state_from_arrays",
    "photometric_loss",
    "position_lr_schedule",
    "psnr",
    "reset_opacity",
    "save_training_state",
    "seed_count",
    "ssim",
    "ssim_map",
    "zero_densify_acc",
]
