from .optimizer import (
    AdamW,
    Quantized8,
    ReduceLROnPlateau,
    StepLR,
    adamw,
    apply_updates_sr,
    build_optimizer,
    cosine_annealing,
    dequantize_blockwise,
    ema_params,
    quantize_blockwise,
    reduce_on_plateau,
    step_lr,
    stochastic_round_to,
    with_ema,
)
from .incremental import IncrementalFNOTrainer
from .patching import MultigridPatching2D, make_patches
from .profiling import ThroughputMeter, flops_per_fno_step, trace
from .setup import setup
from .tensor_galore import TensorGaLoreProjector, tensor_galore_adamw
from .trainer import Trainer
from .training_state import (
    load_training_state,
    load_training_state_orbax,
    save_training_state,
    save_training_state_orbax,
)

__all__ = ["AdamW", "IncrementalFNOTrainer", "MultigridPatching2D", "Quantized8",
           "ReduceLROnPlateau", "StepLR", "TensorGaLoreProjector", "ThroughputMeter", "Trainer",
           "adamw", "apply_updates_sr", "build_optimizer", "cosine_annealing",
           "dequantize_blockwise", "ema_params", "flops_per_fno_step", "load_training_state",
           "load_training_state_orbax", "make_patches", "quantize_blockwise",
           "reduce_on_plateau", "save_training_state", "save_training_state_orbax", "setup",
           "step_lr", "stochastic_round_to", "tensor_galore_adamw", "trace", "with_ema"]
