"""Pointwise channel MLPs (port of ``neuraloperator_tpu/layers/channel_mlp.py``):
``ChannelMLP``, channels first, and ``LinearChannelMLP``, channels last (the
kernel network of the GNO layers)."""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from . import _init
from .normalization_layers import Dense


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


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x`` itself when ``deterministic`` or at rate 0,
    zeros at rate 1, else each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)`` in ``x``'s dtype. The keep mask is drawn
    from ``generator`` (on ``x``'s device; torch's default one when None):
    its values are not JAX's, whose ``jax.random`` bits torch cannot draw."""
    if rate == 0.0 or deterministic:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ChannelMLP(nn.Module):
    """Channels-first pointwise MLP: (b, c, d1..dN) -> (b, out, d1..dN).

    Parameters ``w{i}`` of shape ``(out, in)`` (flax ``lecun_normal``) and
    ``b{i}`` of shape ``(out,)`` (zeros), as in the JAX module. Each layer
    computes in the promoted dtype of its input and weight, as the JAX
    einsum does: bf16 on bf16, f32 when either is f32. With ``dropout`` > 0
    each layer's output goes through :func:`dropout`, which is inert unless
    ``forward`` is called with ``deterministic=False``, as in the JAX module
    (whose callers in the package never pass it: there dropout never fires).
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
        self.dropout = dropout
        self.out_channels = out_channels or in_channels
        hidden = hidden_channels or in_channels
        self.n_layers = n_layers
        self.non_linearity = non_linearity
        for i in range(n_layers):
            d_in = in_channels if i == 0 else hidden
            d_out = self.out_channels if i == n_layers - 1 else hidden
            setattr(self, f"w{i}", _init.lecun_normal((d_out, d_in), device, generator))
            setattr(self, f"b{i}", _init.constant((d_out,), 0.0, device))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, _, *spatial = x.shape
        h = x.reshape(b, x.shape[1], -1)
        for i in range(self.n_layers):
            w = getattr(self, f"w{i}")
            dtype = torch.promote_types(h.dtype, w.dtype)
            h = torch.matmul(w.to(dtype), h.to(dtype)) + getattr(self, f"b{i}")[:, None]
            if i < self.n_layers - 1:
                h = self.non_linearity(h)
            if self.dropout > 0.0:
                h = dropout(h, self.dropout, deterministic, generator)
        return h.reshape(b, self.out_channels, *spatial)


class LinearChannelMLP(nn.Module):
    """Channels-last MLP over point features: (..., layers[0]) -> (..., layers[-1]).

    flax ``nn.Dense`` layers named ``fc{i}`` (``kernel`` (in, out), lecun
    normal; ``bias`` zeros), ``non_linearity`` between them and none after
    the last, as in the JAX module. The products are ``torch.matmul`` at
    ``training.setup``'s matmul precision, as JAX's ``nn.Dense`` follows its
    default precision. ``dropout`` behaves as :class:`ChannelMLP`'s.
    """

    def __init__(
        self,
        layers: Sequence[int],
        non_linearity: Callable = gelu,
        dropout: float = 0.0,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if len(layers) < 2:
            raise ValueError("LinearChannelMLP needs at least two layer sizes")
        self.n_layers = len(layers) - 1
        self.non_linearity = non_linearity
        self.dropout = dropout
        for i in range(self.n_layers):
            setattr(self, f"fc{i}", Dense(layers[i], layers[i + 1], device=device,
                                          generator=generator))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n_layers - 1:
                x = self.non_linearity(x)
            if self.dropout > 0.0:
                x = dropout(x, self.dropout, deterministic, generator)
        return x
