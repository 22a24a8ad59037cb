"""U-shaped Neural Operator (port of ``neuraloperator_tpu/models/uno.py``).

Per-layer output channels, modes and resolution scalings, with horizontal
skips: an earlier block's output, through ``horizontal_skip_{i}``, is
resampled (bicubic, ``layers/resample.py``) to the current grid and
concatenated on the channel axis. Blocks are ``block_{i}``, one-layer
``FNOBlocks``; the last one is given the end-to-end output size
(``int(round(size * scaling))``, as the JAX module computes it).
"""

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from .._common import resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.embeddings import GridEmbedding2D, GridEmbeddingND
from ..layers.fno_block import FNOBlocks
from ..layers.padding import domain_padding_or_none
from ..layers.resample import resample
from ..layers.skip_connections import skip_connection
from .base_model import register_model


def _per_dim(s, n_dim: int) -> list:
    return [s] * n_dim if isinstance(s, (int, float)) else list(s)


@register_model(name="UNO")
class UNO(nn.Module):
    """``forward(x)``: (b, in, d1..dN) -> (b, out, o1..oN), o = d times the
    product of ``uno_scalings``. ``horizontal_skips_map`` maps a block to
    the earlier block whose output it takes in; by default the U shape
    ``{n-1: 0, n-2: 1, ...}``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        hidden_channels: int,
        lifting_channels: int = 256,
        projection_channels: int = 256,
        positional_embedding="grid",
        n_layers: int = 4,
        uno_out_channels: Optional[Sequence[int]] = None,
        uno_n_modes: Optional[Sequence[Sequence[int]]] = None,
        uno_scalings: Optional[Sequence] = None,
        horizontal_skips_map: Optional[Dict[int, int]] = None,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        non_linearity: Callable = gelu,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        preactivation: bool = False,
        fno_skip: Optional[str] = "linear",
        horizontal_skip: Optional[str] = "linear",
        channel_mlp_skip: Optional[str] = "soft-gating",
        separable: bool = False,
        factorization: Optional[str] = None,
        rank=1.0,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        domain_padding=None,
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if uno_out_channels is None or uno_n_modes is None or uno_scalings is None:
            raise ValueError("UNO needs uno_out_channels, uno_n_modes and uno_scalings")
        if not len(uno_out_channels) == len(uno_n_modes) == len(uno_scalings) == n_layers:
            raise ValueError("uno_out_channels, uno_n_modes and uno_scalings need one entry "
                             "per layer")
        device = resolve_device(device)
        n_dim = len(uno_n_modes[0])
        self.n_dim, self.n_layers = n_dim, n_layers
        pe = positional_embedding
        if pe == "grid":
            self.embedding = GridEmbeddingND(in_channels, dim=n_dim)
        elif isinstance(pe, (GridEmbedding2D, GridEmbeddingND)) or pe is None:
            self.embedding = pe
        else:
            raise ValueError(f"invalid positional_embedding {pe!r}")
        if horizontal_skips_map is not None:
            self.skips_map = {int(k): int(v) for k, v in dict(horizontal_skips_map).items()}
        else:
            self.skips_map = {n_layers - i - 1: i for i in range(n_layers // 2)}
        self.end_to_end_scaling = [1.0] * n_dim
        for s in uno_scalings:
            self.end_to_end_scaling = [a * b for a, b in
                                       zip(self.end_to_end_scaling, _per_dim(s, n_dim))]
        kw = dict(device=device, generator=generator)
        self.lifting = ChannelMLP(
            in_channels + (n_dim if self.embedding is not None else 0),
            out_channels=hidden_channels, hidden_channels=lifting_channels, n_layers=2, **kw)
        prev_out = hidden_channels
        for i in range(n_layers):
            if i in self.skips_map:
                prev_out = prev_out + uno_out_channels[self.skips_map[i]]
            self.add_module(f"block_{i}", FNOBlocks(
                prev_out, uno_out_channels[i], tuple(uno_n_modes[i]),
                channel_mlp_dropout=channel_mlp_dropout,
                channel_mlp_expansion=channel_mlp_expansion,
                resolution_scaling_factor=[tuple(_per_dim(uno_scalings[i], n_dim))],
                non_linearity=non_linearity, norm=norm, norm_groups=norm_groups,
                preactivation=preactivation, fno_skip=fno_skip,
                channel_mlp_skip=channel_mlp_skip, rank=rank,
                fixed_rank_modes=fixed_rank_modes, implementation=implementation,
                separable=separable, factorization=factorization,
                enforce_hermitian_symmetry=enforce_hermitian_symmetry, n_layers=1, **kw))
            if i in self.skips_map.values():
                self.add_module(f"horizontal_skip_{i}", skip_connection(
                    uno_out_channels[i], uno_out_channels[i], skip_type=horizontal_skip,
                    n_dim=n_dim, **kw))
            prev_out = uno_out_channels[i]
        self.projection = ChannelMLP(prev_out, out_channels=out_channels,
                                     hidden_channels=projection_channels, n_layers=2,
                                     non_linearity=non_linearity, **kw)
        self.domain_padding = domain_padding_or_none(domain_padding, self.end_to_end_scaling)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.embedding is not None:
            x = self.embedding(x)
        x = self.lifting(x)
        if self.domain_padding is not None:
            x = self.domain_padding.pad(x)
        output_shape = tuple(int(round(i * j)) for i, j in
                             zip(x.shape[-self.n_dim:], self.end_to_end_scaling))
        axes = list(range(-self.n_dim, 0))
        skip_outputs = {}
        for i in range(self.n_layers):
            if i in self.skips_map:
                skip_val = skip_outputs[self.skips_map[i]]
                factors = [m / n for m, n in
                           zip(x.shape[-self.n_dim:], skip_val.shape[-self.n_dim:])]
                x = torch.cat([x, resample(skip_val, factors, axes)], dim=1)
            last = i == self.n_layers - 1
            x = getattr(self, f"block_{i}")(x, 0, output_shape=output_shape if last else None)
            if i in self.skips_map.values():
                skip_outputs[i] = getattr(self, f"horizontal_skip_{i}")(x)
        if self.domain_padding is not None:
            x = self.domain_padding.unpad(x)
        return self.projection(x)
