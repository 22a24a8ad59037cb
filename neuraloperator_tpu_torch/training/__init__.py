from .optimizer import AdamW, StepLR, adamw, build_optimizer, step_lr
from .trainer import Trainer
from .training_state import load_training_state

__all__ = ["AdamW", "StepLR", "Trainer", "adamw", "build_optimizer", "load_training_state",
           "step_lr"]
