"""LocalNO: the FNO skeleton with local integral and differential kernels
(port of ``neuraloperator_tpu/models/local_no.py``).

Grid embedding -> lifting ChannelMLP -> optional domain padding ->
``LocalNOBlocks`` (spectral + finite-difference + DISCO branches) ->
unpadding -> projection ChannelMLP. ``default_in_shape`` is the training
grid: it sizes the DISCO stencils and scales the derivatives.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .._common import resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.embeddings import GridEmbeddingND
from ..layers.local_no_block import LocalNOBlocks
from ..layers.padding import domain_padding_or_none
from .base_model import register_model


@register_model(name="LocalNO")
class LocalNO(nn.Module):
    """``forward(x, output_shape=None)``: (b, in, d1..dN) -> (b, out, o1..oN);
    ``output_shape`` is None, a tuple (the last layer's size) or a list of
    per-layer sizes, as in the JAX module."""

    def __init__(
        self,
        n_modes: Sequence[int],
        in_channels: int,
        out_channels: int,
        hidden_channels: int,
        default_in_shape: Sequence[int],
        n_layers: int = 4,
        disco_layers=True,
        disco_kernel_shape: Sequence[int] = (2, 4),
        radius_cutoff: Optional[float] = None,
        domain_length: Sequence[float] = (2.0, 2.0),
        disco_groups: int = 1,
        disco_bias: bool = True,
        diff_layers=True,
        conv_padding_mode: str = "periodic",
        fin_diff_kernel_size: int = 3,
        mix_derivatives: bool = True,
        lifting_channel_ratio: float = 2,
        projection_channel_ratio: float = 2,
        positional_embedding="grid",
        non_linearity: Callable = gelu,
        norm: Optional[str] = None,
        preactivation: bool = False,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        channel_mlp_skip: Optional[str] = "soft-gating",
        local_no_skip: Optional[str] = "linear",
        resolution_scaling_factor=None,
        domain_padding=None,
        local_no_block_precision: str = "full",
        stabilizer: Optional[str] = None,
        max_n_modes: Optional[Sequence[int]] = None,
        factorization: Optional[str] = None,
        rank=1.0,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        separable: bool = False,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        n_dim = len(n_modes)
        self.n_layers = n_layers
        self.embedding = (GridEmbeddingND(in_channels, dim=n_dim)
                          if positional_embedding == "grid" else None)
        kw = dict(device=device, generator=generator)
        self.lifting = ChannelMLP(
            in_channels + (n_dim if self.embedding is not None else 0),
            out_channels=hidden_channels,
            hidden_channels=int(lifting_channel_ratio * hidden_channels),
            n_layers=2, non_linearity=non_linearity, **kw)
        self.local_no_blocks = LocalNOBlocks(
            hidden_channels, hidden_channels, n_modes, default_in_shape,
            resolution_scaling_factor=resolution_scaling_factor, n_layers=n_layers,
            disco_layers=disco_layers, disco_kernel_shape=disco_kernel_shape,
            radius_cutoff=radius_cutoff, domain_length=domain_length,
            disco_groups=disco_groups, disco_bias=disco_bias, diff_layers=diff_layers,
            conv_padding_mode=conv_padding_mode, fin_diff_kernel_size=fin_diff_kernel_size,
            mix_derivatives=mix_derivatives, max_n_modes=max_n_modes,
            local_no_block_precision=local_no_block_precision, use_channel_mlp=True,
            channel_mlp_dropout=channel_mlp_dropout,
            channel_mlp_expansion=channel_mlp_expansion, non_linearity=non_linearity,
            stabilizer=stabilizer, norm=norm, preactivation=preactivation,
            local_no_skip=local_no_skip, channel_mlp_skip=channel_mlp_skip,
            separable=separable, factorization=factorization, rank=rank,
            fixed_rank_modes=fixed_rank_modes, implementation=implementation, **kw)
        self.projection = ChannelMLP(
            hidden_channels, out_channels=out_channels,
            hidden_channels=int(projection_channel_ratio * hidden_channels),
            n_layers=2, non_linearity=non_linearity, **kw)
        self.domain_padding = domain_padding_or_none(domain_padding, resolution_scaling_factor)

    def forward(self, x: torch.Tensor, output_shape=None) -> torch.Tensor:
        if self.embedding is not None:
            x = self.embedding(x)
        x = self.lifting(x)
        if self.domain_padding is not None:
            x = self.domain_padding.pad(x)
        if output_shape is None:
            output_shapes = [None] * self.n_layers
        elif isinstance(output_shape, tuple):
            output_shapes = [None] * (self.n_layers - 1) + [output_shape]
        else:
            output_shapes = list(output_shape)
        for i in range(self.n_layers):
            x = self.local_no_blocks(x, i, output_shape=output_shapes[i])
        if self.domain_padding is not None:
            x = self.domain_padding.unpad(x)
        return self.projection(x)
