"""Fourier layers with parallel local branches (port of
``neuraloperator_tpu/layers/local_no_block.py``).

Each layer sums a spectral convolution, an optional finite-difference
branch and an optional equidistant DISCO branch, each local branch brought
to the layer's output size by ``SpectralConv.transform``, then norm, skip
and channel MLP in the JAX module's post-activation order. Submodules keep
the JAX names: ``conv_{i}`` per layer, ``diff_{j}`` and ``disco_{j}``
numbered over the layers that have them, ``local_no_skip_{i}``,
``channel_mlp_{i}``, ``channel_mlp_skip_{i}`` and ``norm_{j}`` (two per
layer). The DISCO stencil's size comes from ``default_in_shape`` and the
derivative is rescaled by the relative grid width, so a model trained at
16² evaluates at 32² on the same stencils.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..utils import validate_scaling_factor
from .channel_mlp import ChannelMLP, gelu
from .differential_conv import FiniteDifferenceConvolution
from .discrete_continuous_convolution import EquidistantDiscreteContinuousConv2d
from .normalization_layers import AdaIN, GroupNorm, InstanceNorm
from .skip_connections import skip_connection
from .spectral_convolution import SpectralConv


def disco_kernel_size(radius_cutoff: Optional[float], default_in_shape: Sequence[int]) -> int:
    """The DISCO stencil's odd size: 3 at 16² with the default cutoff."""
    radius = radius_cutoff if radius_cutoff is not None else 2.0 / min(default_in_shape)
    half = max(1, round(radius * min(default_in_shape) / 2) * 2 // 2)
    return 2 * half + 1


class LocalNOBlocks(nn.Module):
    """A stack of ``n_layers`` local-NO layers; ``forward(x, index)`` runs one.

    ``diff_layers`` and ``disco_layers`` are a bool for every layer or one
    per layer. ``domain_length``, ``preactivation`` and
    ``local_no_block_precision`` other than "full" are accepted and, as in
    the JAX module, change nothing but the spectral convolution's precision.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_modes: Sequence[int],
        default_in_shape: Sequence[int],
        resolution_scaling_factor=None,
        n_layers: int = 1,
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
        max_n_modes: Optional[Sequence[int]] = None,
        local_no_block_precision: str = "full",
        use_channel_mlp: bool = True,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        non_linearity: Callable = gelu,
        stabilizer: Optional[str] = None,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        ada_in_features: Optional[int] = None,
        preactivation: bool = False,
        local_no_skip: Optional[str] = "linear",
        channel_mlp_skip: Optional[str] = "soft-gating",
        separable: bool = False,
        factorization: Optional[str] = None,
        rank=1.0,
        conv_module: type = SpectralConv,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        fft_norm: str = "forward",
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del domain_length, preactivation
        n_dim = len(n_modes)
        if len(default_in_shape) != n_dim:
            raise ValueError("default_in_shape needs one size per dim of n_modes")

        def flags(value):
            return (value,) * n_layers if isinstance(value, bool) else tuple(value)

        diff_flags, disco_flags = flags(diff_layers), flags(disco_layers)
        if n_dim > 3 and any(diff_flags):
            raise NotImplementedError("differential convs not implemented for dims > 3")
        if n_dim != 2 and any(disco_flags):
            raise NotImplementedError("DISCO layers only implemented for 2-D")
        if norm not in (None, "instance_norm", "group_norm", "ada_in"):
            raise ValueError(f"unsupported norm {norm!r}")
        self.n_layers = n_layers
        self.default_in_shape = tuple(default_in_shape)
        self.non_linearity = non_linearity
        self.stabilizer = stabilizer
        self.norm = norm
        self.use_channel_mlp = use_channel_mlp
        self.local_no_skip = local_no_skip
        self.channel_mlp_skip = channel_mlp_skip if use_channel_mlp else None
        rsf = validate_scaling_factor(resolution_scaling_factor, n_dim, n_layers)
        kw = dict(device=device, generator=generator)
        for i in range(n_layers):
            self.add_module(f"conv_{i}", conv_module(
                in_channels, out_channels, n_modes,
                resolution_scaling_factor=None if rsf is None else tuple(rsf[i]),
                max_n_modes=max_n_modes, rank=rank, fixed_rank_modes=fixed_rank_modes,
                implementation=implementation, separable=separable,
                factorization=factorization, fno_block_precision=local_no_block_precision,
                fft_norm=fft_norm, enforce_hermitian_symmetry=enforce_hermitian_symmetry, **kw))

        # per layer, the index of its branch among the layers that have one, or -1
        self.diff_index, j = [], 0
        for i in range(n_layers):
            self.diff_index.append(j if diff_flags[i] else -1)
            if diff_flags[i]:
                self.add_module(f"diff_{j}", FiniteDifferenceConvolution(
                    in_channels, out_channels, n_dim, kernel_size=fin_diff_kernel_size,
                    groups=1 if mix_derivatives else in_channels, padding=conv_padding_mode,
                    **kw))
                j += 1
        kernel_size = disco_kernel_size(radius_cutoff, default_in_shape)
        self.disco_index, j = [], 0
        for i in range(n_layers):
            self.disco_index.append(j if disco_flags[i] else -1)
            if disco_flags[i]:
                self.add_module(f"disco_{j}", EquidistantDiscreteContinuousConv2d(
                    in_channels, out_channels, kernel_shape=tuple(disco_kernel_shape),
                    kernel_size=kernel_size, groups=disco_groups, use_bias=disco_bias,
                    padding_mode=("periodic" if conv_padding_mode in ("periodic", "circular")
                                  else "zeros"), **kw))
                j += 1

        for i in range(n_layers):
            if local_no_skip is not None:
                self.add_module(f"local_no_skip_{i}", skip_connection(
                    in_channels, out_channels, n_dim=n_dim, skip_type=local_no_skip, **kw))
        if use_channel_mlp:
            for i in range(n_layers):
                self.add_module(f"channel_mlp_{i}", ChannelMLP(
                    out_channels, hidden_channels=round(out_channels * channel_mlp_expansion),
                    dropout=channel_mlp_dropout, **kw))
            if channel_mlp_skip is not None:
                for i in range(n_layers):
                    self.add_module(f"channel_mlp_skip_{i}", skip_connection(
                        in_channels, out_channels, n_dim=n_dim, skip_type=channel_mlp_skip,
                        **kw))
        if norm is not None:
            for j in range(2 * n_layers):
                if norm == "instance_norm":
                    module = InstanceNorm()
                elif norm == "group_norm":
                    module = GroupNorm(norm_groups, out_channels, device=device)
                else:
                    module = AdaIN(ada_in_features, out_channels, **kw)
                self.add_module(f"norm_{j}", module)

    def _norm(self, j: int, x: torch.Tensor, ada_in_embedding) -> torch.Tensor:
        module = getattr(self, f"norm_{j}")
        if isinstance(module, AdaIN):
            return module(x, ada_in_embedding)
        return module(x)

    def forward(self, x: torch.Tensor, index: int = 0, output_shape=None,
                ada_in_embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = getattr(self, f"conv_{index}")
        x_skip = x_skip_mlp = None
        if self.local_no_skip is not None:
            x_skip = conv.transform(getattr(self, f"local_no_skip_{index}")(x), output_shape)
        if self.channel_mlp_skip is not None:
            x_skip_mlp = conv.transform(getattr(self, f"channel_mlp_skip_{index}")(x),
                                        output_shape)
        if self.stabilizer == "tanh":
            x = torch.tanh(x)

        h = conv(x, output_shape=output_shape)
        if self.diff_index[index] != -1:
            # the discrete derivative rescaled by the relative grid width
            gw = 1.0 / (x.shape[-1] / self.default_in_shape[0])
            d = getattr(self, f"diff_{self.diff_index[index]}")(x, gw)
            h = h + conv.transform(d, output_shape)
        if self.disco_index[index] != -1:
            lc = getattr(self, f"disco_{self.disco_index[index]}")(x)
            h = h + conv.transform(lc, output_shape)

        if self.norm is not None:
            h = self._norm(2 * index, h, ada_in_embedding)
        x = h + x_skip if x_skip is not None else h
        last = index == self.n_layers - 1
        if self.use_channel_mlp or not last:
            x = self.non_linearity(x)
        if self.use_channel_mlp:
            x = getattr(self, f"channel_mlp_{index}")(x)
            if x_skip_mlp is not None:
                x = x + x_skip_mlp
            if self.norm is not None:
                x = self._norm(2 * index + 1, x, ada_in_embedding)
            if not last:
                x = self.non_linearity(x)
        return x
