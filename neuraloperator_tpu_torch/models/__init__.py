from .base_model import (
    available_models,
    from_checkpoint,
    get_model,
    load_checkpoint,
    load_flagship,
    model_from_metadata,
    register_model,
    save_arch_metadata,
    save_checkpoint,
)
from .codano import CODANO, extend_variable_ids
from .fno import FNO, TFNO, partialclass
from .fnogno import FNOGNO
from .gino import GINO
from .local_no import LocalNO
from .otno import OTNO
from .rno import RNO
from .sfno import SFNO
from .uno import UNO
from .uqno import UQNO

__all__ = ["CODANO", "FNO", "FNOGNO", "GINO", "LocalNO", "OTNO", "RNO", "SFNO", "TFNO", "UNO",
           "UQNO", "available_models", "extend_variable_ids", "from_checkpoint", "get_model",
           "load_checkpoint", "load_flagship", "model_from_metadata", "partialclass",
           "register_model", "save_arch_metadata", "save_checkpoint"]
