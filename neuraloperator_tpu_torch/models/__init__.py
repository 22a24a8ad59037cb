from .base_model import (
    available_models,
    from_checkpoint,
    get_model,
    load_checkpoint,
    load_flagship,
    model_from_metadata,
    register_model,
    save_arch_metadata,
)
from .fno import FNO, TFNO

__all__ = ["FNO", "TFNO", "available_models", "from_checkpoint", "get_model", "load_checkpoint",
           "load_flagship", "model_from_metadata", "register_model", "save_arch_metadata"]
