"""Fourier layers (port of ``neuraloperator_tpu/layers/fno_block.py``).

Ported: the post-activation path without norms, stabilizer or local conv
bias. Submodules keep the JAX names ``conv_{i}``, ``fno_skip_{i}``,
``channel_mlp_{i}`` and ``channel_mlp_skip_{i}``.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .._common import not_ported
from .channel_mlp import ChannelMLP, gelu
from .skip_connections import skip_connection
from .spectral_convolution import SpectralConv


class FNOBlocks(nn.Module):
    """A stack of ``n_layers`` Fourier layers; ``forward(x, index)`` runs one."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_modes: Sequence[int],
        resolution_scaling_factor=None,
        n_layers: int = 1,
        max_n_modes: Optional[Sequence[int]] = None,
        fno_block_precision: str = "full",
        use_channel_mlp: bool = True,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        non_linearity: Callable = gelu,
        stabilizer: Optional[str] = None,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        ada_in_features: Optional[int] = None,
        preactivation: bool = False,
        fno_skip: Optional[str] = "linear",
        conv_bias_kernel: int = 1,
        channel_mlp_skip: Optional[str] = "soft-gating",
        complex_data: bool = False,
        separable: bool = False,
        factorization: Optional[str] = None,
        rank=1.0,
        conv_module: type = SpectralConv,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        decomposition_kwargs: Optional[dict] = None,
        enforce_hermitian_symmetry: bool = True,
        weight_dtype: str = "float32",
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del norm_groups, ada_in_features, decomposition_kwargs
        if norm is not None:
            raise not_ported(f"FNOBlocks norm={norm!r}", "the other families")
        if preactivation:
            raise not_ported("FNOBlocks preactivation=True", "the other families")
        if stabilizer is not None:
            raise not_ported(f"FNOBlocks stabilizer={stabilizer!r}", "the other families")
        if conv_bias_kernel != 1:
            raise not_ported("FNOBlocks conv_bias_kernel > 1", "the other families")
        if complex_data:
            raise not_ported("FNOBlocks complex_data=True", "the other families")
        if conv_module is not SpectralConv:
            raise not_ported(f"FNOBlocks conv_module={conv_module!r}", "the other families")
        self.n_layers = n_layers
        self.non_linearity = non_linearity
        self.use_channel_mlp = use_channel_mlp
        self.fno_skip = fno_skip
        self.channel_mlp_skip = channel_mlp_skip if use_channel_mlp else None
        n_dim = len(n_modes)
        for i in range(n_layers):
            self.add_module(f"conv_{i}", conv_module(
                in_channels, out_channels, n_modes,
                max_n_modes=max_n_modes,
                resolution_scaling_factor=resolution_scaling_factor,
                fno_block_precision=fno_block_precision,
                rank=rank,
                factorization=factorization,
                implementation=implementation,
                separable=separable,
                fixed_rank_modes=fixed_rank_modes,
                enforce_hermitian_symmetry=enforce_hermitian_symmetry,
                weight_dtype=weight_dtype,
                device=device,
                generator=generator,
            ))
            if fno_skip is not None:
                self.add_module(f"fno_skip_{i}", skip_connection(
                    in_channels, out_channels, n_dim=n_dim, skip_type=fno_skip,
                    device=device, generator=generator,
                ))
            if use_channel_mlp:
                self.add_module(f"channel_mlp_{i}", ChannelMLP(
                    out_channels,
                    hidden_channels=round(out_channels * channel_mlp_expansion),
                    dropout=channel_mlp_dropout,
                    device=device,
                    generator=generator,
                ))
                if channel_mlp_skip is not None:
                    self.add_module(f"channel_mlp_skip_{i}", skip_connection(
                        in_channels, out_channels, n_dim=n_dim,
                        skip_type=channel_mlp_skip,
                        device=device, generator=generator,
                    ))

    def forward(self, x: torch.Tensor, index: int = 0) -> torch.Tensor:
        conv = getattr(self, f"conv_{index}")
        x_skip_fno = None
        if self.fno_skip is not None:
            x_skip_fno = conv.transform(getattr(self, f"fno_skip_{index}")(x))
        x_skip_mlp = None
        if self.channel_mlp_skip is not None:
            x_skip_mlp = conv.transform(getattr(self, f"channel_mlp_skip_{index}")(x))

        x_fno = conv(x)
        x = x_fno + x_skip_fno if x_skip_fno is not None else x_fno
        if index < self.n_layers - 1:
            x = self.non_linearity(x)

        if self.use_channel_mlp:
            x = getattr(self, f"channel_mlp_{index}")(x)
            if x_skip_mlp is not None:
                x = x + x_skip_mlp
        if index < self.n_layers - 1:
            x = self.non_linearity(x)
        return x
