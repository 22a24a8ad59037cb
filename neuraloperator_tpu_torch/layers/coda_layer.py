"""Codomain attention (port of ``neuraloperator_tpu/layers/coda_layer.py``).

Channel groups are token functions. ``Key``, ``Query``, ``Value``,
``multi_head_proj`` and the two-layer ``mixer`` are ``FNOBlocks`` with the
layer's defaults (rank-1.0 Tucker weights contracted "factorized": the
einsum chain, no contraction kernel); attention scores are inner products of
the flattened key and query functions (the keys at ``scale`` times the
resolution), scaled, soft-maxed and applied to the values with
``torch.einsum``, in the JAX module's order (not
``scaled_dot_product_attention``, which on the card may pick reduced
precision). The norms are ``GroupNorm(groups=channels)``: an instance norm
with a per-channel affine, as in the JAX module. ``conv_module`` is any
convolution class ``FNOBlocks`` takes (``SphericalConv`` for one).
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .channel_mlp import gelu
from .fno_block import FNOBlocks
from .normalization_layers import GroupNorm
from .resample import resample
from .spectral_convolution import SpectralConv


def _identity(x):
    return x


class CODALayer(nn.Module):
    """``forward(x, output_shape=None)``: (b, t * token_codimension, d1..dN)
    -> the same layout, at ``output_shape`` (or ``resolution_scaling_factor``
    times the input size, floored as in the JAX module)."""

    def __init__(
        self,
        n_modes: Sequence[int],
        n_heads: int = 1,
        token_codimension: int = 1,
        head_codimension: Optional[int] = None,
        codimension_size: Optional[int] = None,
        per_channel_attention: bool = True,
        permutation_eq: bool = True,
        norm: Optional[str] = "instance_norm",
        temperature: float = 1.0,
        nonlinear_attention: bool = False,
        scale: Optional[float] = None,
        resolution_scaling_factor: Optional[float] = None,
        non_linearity: Callable = gelu,
        use_channel_mlp: bool = True,
        channel_mlp_expansion: float = 1.0,
        fno_skip: str = "linear",
        channel_mlp_skip: str = "linear",
        preactivation: bool = False,
        separable: bool = False,
        factorization: Optional[str] = "tucker",
        rank: float = 1.0,
        conv_module: type = SpectralConv,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if norm not in (None, "instance_norm"):
            raise ValueError(f"unknown norm {norm!r}")
        self.n_dim = len(n_modes)
        self.n_heads, self.temperature = n_heads, temperature
        self.permutation_eq = permutation_eq
        self.resolution_scaling_factor = resolution_scaling_factor
        self.token_codim = 1 if per_channel_attention else token_codimension
        head_codim = 1 if per_channel_attention else (head_codimension or token_codimension)
        if scale is None:
            scale = 0.5 if per_channel_attention else 1.0
        kw = dict(device=device, generator=generator)
        shared = dict(
            use_channel_mlp=use_channel_mlp, preactivation=preactivation,
            channel_mlp_skip=channel_mlp_skip, channel_mlp_dropout=0.0, rank=rank,
            channel_mlp_expansion=channel_mlp_expansion, fixed_rank_modes=fixed_rank_modes,
            implementation=implementation, separable=separable, factorization=factorization,
            conv_module=conv_module, enforce_hermitian_symmetry=enforce_hermitian_symmetry,
            **kw)
        kqv = dict(non_linearity=non_linearity if nonlinear_attention else _identity,
                   fno_skip="linear", norm=None, n_layers=1, **shared)
        heads_width = n_heads * head_codim
        self.Key = FNOBlocks(self.token_codim, heads_width, n_modes,
                             resolution_scaling_factor=scale, **kqv)
        self.Query = FNOBlocks(self.token_codim, heads_width, n_modes,
                               resolution_scaling_factor=scale, **kqv)
        self.Value = FNOBlocks(self.token_codim, heads_width, n_modes,
                               resolution_scaling_factor=1, **kqv)
        self.multi_head_proj = None
        if heads_width != self.token_codim:
            self.multi_head_proj = FNOBlocks(
                heads_width, self.token_codim, n_modes, resolution_scaling_factor=1,
                non_linearity=_identity, fno_skip="linear", norm=None, n_layers=1, **shared)

        def norm_module(channels):
            return None if norm is None else GroupNorm(channels, channels, device=device)

        mixer_channels = self.token_codim if permutation_eq else codimension_size
        self.attention_normalizer = norm_module(self.token_codim)
        self.mixer = FNOBlocks(mixer_channels, mixer_channels, n_modes,
                               resolution_scaling_factor=1, non_linearity=non_linearity,
                               norm="instance_norm", fno_skip=fno_skip, n_layers=2, **shared)
        self.norm1 = norm_module(mixer_channels)
        self.mixer_in_normalizer = norm_module(mixer_channels)
        self.mixer_out_normalizer = norm_module(mixer_channels)

    @staticmethod
    def _maybe(norm, x):
        return x if norm is None else norm(x)

    def compute_attention(self, tokens: torch.Tensor, batch_size: int) -> torch.Tensor:
        """tokens (b * t, d, spatial...) -> the attention output, same layout."""
        k, q, v = self.Key(tokens), self.Query(tokens), self.Value(tokens)
        t = k.shape[0] // batch_size
        d = k.shape[1] // self.n_heads

        def heads(z):
            z = z.reshape(batch_size, t, self.n_heads, d, *z.shape[-self.n_dim:])
            return z.transpose(1, 2).reshape(batch_size, self.n_heads, t, -1)

        kf, qf, vf = heads(k), heads(q), heads(v)
        dprod = torch.einsum("bhtd,bhsd->bhts", qf, kf) / (
            (1.0 * kf.shape[-1]) ** 0.5 * self.temperature)
        dprod = torch.softmax(dprod, dim=-1)
        attention = torch.einsum("bhts,bhsd->bhtd", dprod, vf)
        attention = attention.reshape(batch_size, self.n_heads, t, d, *v.shape[-self.n_dim:])
        return attention.transpose(1, 2).reshape(batch_size * t, self.n_heads * d,
                                                 *v.shape[-self.n_dim:])

    def _resample_to(self, output: torch.Tensor, output_shape) -> torch.Tensor:
        if output_shape is None:
            return output
        factors = [j / i for i, j in zip(output.shape[-self.n_dim:], output_shape)]
        return resample(output, factors, list(range(-self.n_dim, 0)),
                        output_shape=tuple(output_shape))

    def _mix(self, attention: torch.Tensor, input_shape) -> torch.Tensor:
        output = self._maybe(self.mixer_in_normalizer, attention)
        for i in range(2):
            output = self.mixer(output, i, output_shape=tuple(input_shape))
        return self._maybe(self.mixer_out_normalizer, output) + attention

    def forward(self, x: torch.Tensor, output_shape=None) -> torch.Tensor:
        if self.resolution_scaling_factor is not None and output_shape is None:
            output_shape = [int(s * self.resolution_scaling_factor)
                            for s in x.shape[-self.n_dim:]]
        batch_size = x.shape[0]
        input_shape = tuple(x.shape[-self.n_dim:])
        if x.shape[1] % self.token_codim:
            raise ValueError(f"{x.shape[1]} channels are not tokens of "
                             f"{self.token_codim} channels")
        t = x.shape[1] // self.token_codim
        if self.permutation_eq:
            tokens = x.reshape(batch_size * t, self.token_codim, *input_shape)
            attention = self.compute_attention(self._maybe(self.norm1, tokens), batch_size)
        else:
            tokens = self._maybe(self.norm1, x).reshape(batch_size * t, self.token_codim,
                                                        *input_shape)
            attention = self.compute_attention(tokens, batch_size)
        if self.multi_head_proj is not None:
            attention = self.multi_head_proj(attention)
        attention = self._maybe(self.attention_normalizer, attention + tokens)
        if self.permutation_eq:
            output = self._mix(attention, input_shape)
            output = output.reshape(batch_size, t * output.shape[1],
                                    *output.shape[-self.n_dim:])
        else:
            attention = attention.reshape(batch_size, t * attention.shape[1],
                                          *attention.shape[-self.n_dim:])
            output = self._mix(attention, input_shape)
        return self._resample_to(output, output_shape)
