from .loss import LossConfig, compute_losses
from .optim import build_optimizer, build_schedule
from .trainer import Trainer, TrainerConfig

__all__ = [
    "LossConfig",
    "compute_losses",
    "build_optimizer",
    "build_schedule",
    "Trainer",
    "TrainerConfig",
]
