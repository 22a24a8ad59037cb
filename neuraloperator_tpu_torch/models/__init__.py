from .base_model import available_models, get_model, model_from_metadata, register_model
from .fno import FNO

__all__ = ["FNO", "available_models", "get_model", "model_from_metadata", "register_model"]
