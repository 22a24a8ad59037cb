"""UQNO: the uncertainty-quantified neural operator (port of
``neuraloperator_tpu/models/uqno.py``).

A trained solution model beside a residual model whose output is a
pointwise quantile band. The solution is detached, so only the residual
model gets gradients (the JAX module's ``stop_gradient``).
"""

import torch
from torch import nn

from .base_model import register_model


@register_model(name="UQNO")
class UQNO(nn.Module):
    """``forward(x, **kwargs)`` -> ``(base_model(x).detach(), residual_model(x))``."""

    def __init__(self, base_model: nn.Module, residual_model: nn.Module):
        super().__init__()
        self.base_model = base_model
        self.residual_model = residual_model

    def forward(self, x: torch.Tensor, **kwargs):
        solution = self.base_model(x, **kwargs).detach()
        return solution, self.residual_model(x, **kwargs)
