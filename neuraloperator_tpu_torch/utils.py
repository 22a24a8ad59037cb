"""Small shared utilities (port of ``count_model_params`` of
``neuraloperator_tpu/utils.py``)."""

import math

import torch


def count_model_params(model: torch.nn.Module) -> int:
    """Total real parameter count of ``model``; a complex entry counts twice,
    as in the JAX package."""
    return sum(
        math.prod(p.shape) * (2 if p.is_complex() else 1)
        for _, p in model.named_parameters()
    )


__all__ = ["count_model_params"]
