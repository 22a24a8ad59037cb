from .optimizer import (
    AdamW,
    Quantized8,
    StepLR,
    adamw,
    apply_updates_sr,
    build_optimizer,
    cosine_annealing,
    dequantize_blockwise,
    ema_params,
    quantize_blockwise,
    step_lr,
    stochastic_round_to,
    with_ema,
)
from .setup import setup
from .trainer import Trainer
from .training_state import load_training_state, save_training_state

__all__ = ["AdamW", "Quantized8", "StepLR", "Trainer", "adamw", "apply_updates_sr",
           "build_optimizer", "cosine_annealing", "dequantize_blockwise", "ema_params",
           "load_training_state", "quantize_blockwise", "save_training_state", "setup",
           "step_lr", "stochastic_round_to", "with_ema"]
