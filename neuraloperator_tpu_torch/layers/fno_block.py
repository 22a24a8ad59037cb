"""Fourier layers (port of ``neuraloperator_tpu/layers/fno_block.py``).

Spectral convolution + skip (linear, soft-gating, identity, or a local
convolution with ``conv_bias_kernel > 1``) + norm + channel MLP + channel-MLP
skip + nonlinearity, in post- or pre-activation order, with the ``tanh``
stabilizer and complex data. Submodules keep the JAX names ``conv_{i}``,
``fno_skip_{i}``, ``channel_mlp_{i}``, ``channel_mlp_skip_{i}`` and
``norm_{j}`` (two per layer); on complex data the skips and channel MLPs
are ``ComplexValued`` pairs. AdaIN's conditioning embedding is a call
argument (``ada_in_embedding``), as in the JAX module. ``conv_module`` is
any convolution class with ``SpectralConv``'s constructor fields (the SFNO
passes ``SphericalConv``); ``enforce_hermitian_symmetry`` and
``weight_dtype`` reach only subclasses of ``SpectralConv``, as in JAX.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..utils import validate_scaling_factor
from .channel_mlp import ChannelMLP, gelu
from .complex import CGELU, ComplexValued, ctanh
from .normalization_layers import AdaIN, BatchNorm, GroupNorm, InstanceNorm
from .skip_connections import LocalConvSkip, skip_connection
from .spectral_convolution import SpectralConv

NORMS = ("instance_norm", "group_norm", "batch_norm", "ada_in")


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
        del decomposition_kwargs
        if norm is not None and norm not in NORMS:
            raise ValueError(
                f"Got norm={norm} but expected None or one of "
                "[instance_norm, group_norm, batch_norm, ada_in]"
            )
        if norm == "ada_in" and ada_in_features is None:
            # the JAX blocks fail at their first call (a None embedding size)
            raise TypeError("norm='ada_in' needs ada_in_features, the embedding's size")
        n_dim = len(n_modes)
        self.n_layers = n_layers
        self.activation = CGELU if complex_data else non_linearity
        self.complex_data = complex_data
        self.stabilizer = stabilizer
        self.preactivation = preactivation
        self.norm = norm
        self.use_channel_mlp = use_channel_mlp
        self.fno_skip = fno_skip
        self.channel_mlp_skip = channel_mlp_skip if use_channel_mlp else None
        if fno_skip is not None and conv_bias_kernel != 1 and fno_skip.lower() != "linear":
            raise ValueError("conv_bias_kernel can only differ from 1 when fno_skip='linear'.")
        rsf = validate_scaling_factor(resolution_scaling_factor, n_dim, n_layers)
        conv_kwargs = {}
        if issubclass(conv_module, SpectralConv):
            conv_kwargs = {"enforce_hermitian_symmetry": enforce_hermitian_symmetry,
                           "weight_dtype": weight_dtype}

        def maybe_complex(factory):
            return ComplexValued(factory) if complex_data else factory()

        def fno_skip_module():
            if fno_skip.lower() == "linear" and conv_bias_kernel > 1:
                return LocalConvSkip(in_channels, out_channels, n_dim, conv_bias_kernel,
                                     device=device, generator=generator)
            return skip_connection(in_channels, out_channels, n_dim=n_dim, skip_type=fno_skip,
                                   device=device, generator=generator)

        for i in range(n_layers):
            self.add_module(f"conv_{i}", conv_module(
                in_channels, out_channels, n_modes,
                max_n_modes=max_n_modes,
                resolution_scaling_factor=None if rsf is None else tuple(rsf[i]),
                fno_block_precision=fno_block_precision,
                rank=rank,
                factorization=factorization,
                implementation=implementation,
                separable=separable,
                fixed_rank_modes=fixed_rank_modes,
                complex_data=complex_data,
                device=device,
                generator=generator,
                **conv_kwargs,
            ))
            if fno_skip is not None:
                self.add_module(f"fno_skip_{i}", maybe_complex(fno_skip_module))
            if use_channel_mlp:
                self.add_module(f"channel_mlp_{i}", maybe_complex(lambda: ChannelMLP(
                    out_channels,
                    hidden_channels=round(out_channels * channel_mlp_expansion),
                    dropout=channel_mlp_dropout,
                    device=device,
                    generator=generator,
                )))
                if channel_mlp_skip is not None:
                    self.add_module(f"channel_mlp_skip_{i}", maybe_complex(
                        lambda: skip_connection(in_channels, out_channels, n_dim=n_dim,
                                                skip_type=channel_mlp_skip, device=device,
                                                generator=generator)))
        if norm is not None:
            for j in range(2 * n_layers):
                if norm == "instance_norm":
                    module = InstanceNorm()
                elif norm == "group_norm":
                    module = GroupNorm(norm_groups, out_channels, device=device)
                elif norm == "batch_norm":
                    module = BatchNorm(n_dim, out_channels, device=device)
                else:
                    module = AdaIN(ada_in_features, out_channels, device=device,
                                   generator=generator)
                self.add_module(f"norm_{j}", module)

    def _norm(self, j: int, x: torch.Tensor, ada_in_embedding) -> torch.Tensor:
        module = getattr(self, f"norm_{j}")
        if isinstance(module, AdaIN):
            if ada_in_embedding is None:
                raise ValueError("norm='ada_in' requires passing ada_in_embedding to FNOBlocks")
            return module(x, ada_in_embedding)
        return module(x)

    def _stabilize(self, x: torch.Tensor) -> torch.Tensor:
        if self.stabilizer == "tanh":
            return ctanh(x) if self.complex_data else torch.tanh(x)
        return x

    def _skips(self, x: torch.Tensor, index: int, output_shape):
        conv = getattr(self, f"conv_{index}")
        x_skip_fno = x_skip_mlp = None
        if self.fno_skip is not None:
            x_skip_fno = conv.transform(getattr(self, f"fno_skip_{index}")(x), output_shape)
        if self.channel_mlp_skip is not None:
            x_skip_mlp = conv.transform(getattr(self, f"channel_mlp_skip_{index}")(x),
                                        output_shape)
        return x_skip_fno, x_skip_mlp

    def _channel_mlp(self, x: torch.Tensor, index: int, x_skip_mlp) -> torch.Tensor:
        if self.use_channel_mlp:
            x = getattr(self, f"channel_mlp_{index}")(x)
            if x_skip_mlp is not None:
                x = x + x_skip_mlp
        return x

    def forward(self, x: torch.Tensor, index: int = 0, output_shape=None,
                ada_in_embedding: Optional[torch.Tensor] = None, n_modes=None) -> torch.Tensor:
        conv = getattr(self, f"conv_{index}")
        last = index == self.n_layers - 1
        if self.preactivation:
            x = self.activation(x)
            if self.norm is not None:
                x = self._norm(2 * index, x, ada_in_embedding)
            x_skip_fno, x_skip_mlp = self._skips(x, index, output_shape)
            x = conv(self._stabilize(x), output_shape=output_shape, n_modes=n_modes)
            if x_skip_fno is not None:
                x = x + x_skip_fno
            if not last:
                x = self.activation(x)
            if self.norm is not None:
                x = self._norm(2 * index + 1, x, ada_in_embedding)
            return self._channel_mlp(x, index, x_skip_mlp)

        x_skip_fno, x_skip_mlp = self._skips(x, index, output_shape)
        x = conv(self._stabilize(x), output_shape=output_shape, n_modes=n_modes)
        if self.norm is not None:
            x = self._norm(2 * index, x, ada_in_embedding)
        if x_skip_fno is not None:
            x = x + x_skip_fno
        if not last:
            x = self.activation(x)
        x = self._channel_mlp(x, index, x_skip_mlp)
        if self.norm is not None:
            x = self._norm(2 * index + 1, x, ada_in_embedding)
        if not last:
            x = self.activation(x)
        return x
