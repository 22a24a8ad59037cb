"""Pointwise channel MLP (port of ``neuraloperator_tpu/layers/channel_mlp.py``)."""

from typing import Callable, Optional

import torch
from torch import nn

from .._common import not_ported
from . import _init


# sqrt(1/2) rounded to bf16, as jax.nn.gelu rounds it for bf16 inputs
_SQRT_HALF_BF16 = 0.70703125


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU.

    On bf16 inputs it is ``jax.nn.gelu``'s formula with its roundings,
    ``0.5 * x * erfc(-x * sqrt(1/2))`` with every op rounded to bf16 (the
    constant too): one f32 evaluation rounded once differs from it by some
    2e-3 relative, which the mixed-precision forward compounds to 1e-2.
    """
    if x.dtype == torch.bfloat16:
        return 0.5 * x * torch.erfc(-x * _SQRT_HALF_BF16)
    return nn.functional.gelu(x, approximate="none")


class ChannelMLP(nn.Module):
    """Channels-first pointwise MLP: (b, c, d1..dN) -> (b, out, d1..dN).

    Parameters ``w{i}`` of shape ``(out, in)`` (flax ``lecun_normal``) and
    ``b{i}`` of shape ``(out,)`` (zeros), as in the JAX module. Each layer
    computes in the promoted dtype of its input and weight, as the JAX
    einsum does: bf16 on bf16, f32 when either is f32.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        hidden_channels: Optional[int] = None,
        n_layers: int = 2,
        non_linearity: Callable = gelu,
        dropout: float = 0.0,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if dropout:
            raise not_ported("ChannelMLP dropout", "dropout, scan_layers and remat")
        self.out_channels = out_channels or in_channels
        hidden = hidden_channels or in_channels
        self.n_layers = n_layers
        self.non_linearity = non_linearity
        for i in range(n_layers):
            d_in = in_channels if i == 0 else hidden
            d_out = self.out_channels if i == n_layers - 1 else hidden
            setattr(self, f"w{i}", _init.lecun_normal((d_out, d_in), device, generator))
            setattr(self, f"b{i}", _init.constant((d_out,), 0.0, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, *spatial = x.shape
        h = x.reshape(b, x.shape[1], -1)
        for i in range(self.n_layers):
            w = getattr(self, f"w{i}")
            dtype = torch.promote_types(h.dtype, w.dtype)
            h = torch.matmul(w.to(dtype), h.to(dtype)) + getattr(self, f"b{i}")[:, None]
            if i < self.n_layers - 1:
                h = self.non_linearity(h)
        return h.reshape(b, self.out_channels, *spatial)
