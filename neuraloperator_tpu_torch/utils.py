"""Small shared utilities (port of ``count_model_params``,
``validate_scaling_factor`` and ``compute_explained_variance`` of
``neuraloperator_tpu/utils.py``)."""

import math
from typing import List, Optional, Union

import torch

Number = Union[int, float]


def count_model_params(model: torch.nn.Module) -> int:
    """Total real parameter count of ``model``; a complex entry counts twice,
    as in the JAX package."""
    return sum(
        math.prod(p.shape) * (2 if p.is_complex() else 1)
        for _, p in model.named_parameters()
    )


def validate_scaling_factor(
    scaling_factor: Union[None, Number, List[Number], List[List[Number]]],
    n_dim: int,
    n_layers: Optional[int] = None,
) -> Union[None, List[float], List[List[float]]]:
    """Normalize a resolution scaling factor: a scalar is broadcast over dims
    (and layers); per-layer lists are checked for shape; anything else is
    None, as in the JAX package."""
    if scaling_factor is None:
        return None
    if isinstance(scaling_factor, (float, int)):
        if n_layers is None:
            return [float(scaling_factor)] * n_dim
        return [[float(scaling_factor)] * n_dim] * n_layers
    if isinstance(scaling_factor, (list, tuple)) and len(scaling_factor) > 0:
        if all(isinstance(s, (float, int)) for s in scaling_factor):
            if n_layers is None and len(scaling_factor) == n_dim:
                return [float(s) for s in scaling_factor]
            if n_layers is not None and len(scaling_factor) == n_layers:
                return [[float(s)] * n_dim for s in scaling_factor]
        if all(
            isinstance(s, (list, tuple))
            and len(s) == n_dim
            and all(isinstance(v, (float, int)) for v in s)
            for s in scaling_factor
        ):
            return [[float(v) for v in s] for s in scaling_factor]
    return None


def compute_explained_variance(frequency_max: int, s) -> float:
    """The share of ``sum(s**2)`` in the first ``frequency_max`` entries of
    ``s`` (a negative count drops that many from the end, as a slice does),
    in f32 as the JAX function computes it; the incremental FNO trainer's
    gradient criterion."""
    s = torch.as_tensor(s, dtype=torch.float32)
    total = torch.sum(s ** 2)
    return float(torch.sum(s[:frequency_max] ** 2) / total)


__all__ = ["compute_explained_variance", "count_model_params", "validate_scaling_factor"]
