from .optimizer import AdamW, StepLR, adamw, build_optimizer, step_lr
from .trainer import Trainer

__all__ = ["AdamW", "StepLR", "Trainer", "adamw", "build_optimizer", "step_lr"]
