"""Pointwise channel MLP (port of ``neuraloperator_tpu/layers/channel_mlp.py``)."""

from typing import Callable, Optional

import torch
from torch import nn

from .._common import not_ported
from . import _init


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return nn.functional.gelu(x, approximate="none")


class ChannelMLP(nn.Module):
    """Channels-first pointwise MLP: (b, c, d1..dN) -> (b, out, d1..dN).

    Parameters ``w{i}`` of shape ``(out, in)`` (flax ``lecun_normal``) and
    ``b{i}`` of shape ``(out,)`` (zeros), as in the JAX module.
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
            h = torch.matmul(getattr(self, f"w{i}"), h) + getattr(self, f"b{i}")[:, None]
            if i < self.n_layers - 1:
                h = self.non_linearity(h)
        return h.reshape(b, self.out_channels, *spatial)
