from .base_model import (
    available_models,
    from_checkpoint,
    get_model,
    load_checkpoint,
    load_flagship,
    model_from_metadata,
    register_model,
)
from .fno import FNO

__all__ = ["FNO", "available_models", "from_checkpoint", "get_model", "load_checkpoint",
           "load_flagship", "model_from_metadata", "register_model"]
