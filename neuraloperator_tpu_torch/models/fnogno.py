"""FNOGNO: an FNO on a regular grid, then a GNO from the grid to arbitrary
query points (port of ``neuraloperator_tpu/models/fnogno.py``).

The input function on the grid, with the grid's coordinates appended, goes
through the lifting and the FNO blocks; the output GNO integrates the
latent features over each query's grid neighbours, and the pointwise
projection gives the output. Submodules keep the flax names (``lifting``,
``fno_blocks``, ``gno``, ``projection``).
"""

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .._common import resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.fno_block import FNOBlocks
from ..layers.gno_block import GNOBlock
from ..layers.gno_weighting_functions import dispatch_weighting_fn
from ..layers.spectral_convolution import SpectralConv
from .base_model import register_model
from .gino import ada_embed, ada_in_size


@register_model(name="FNOGNO")
class FNOGNO(nn.Module):
    """``forward(in_p, out_p, f, ada_in=None, neighbors=None)``: ``in_p``
    (n1..nk, k) the grid's coordinates, ``out_p`` (n_out, k) queries, ``f``
    (b, n1..nk, c) or (n1..nk, c) the input function; returns (b, n_out,
    out) or (n_out, out). ``neighbors`` are precomputed neighbourhoods of
    the queries among the grid points; without them the GNO searches inside
    the call. ``gno_batched`` is kept for the reference's signature: the
    batch follows ``f``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        projection_channel_ratio: int = 4,
        gno_coord_dim: int = 3,
        gno_radius: float = 0.033,
        gno_transform_type: str = "linear",
        gno_weighting_function: Optional[str] = None,
        gno_weight_function_scale: float = 1.0,
        gno_pos_embed_type: Optional[str] = "transformer",
        gno_embed_channels: int = 32,
        gno_embed_max_positions: int = 10000,
        gno_channel_mlp_hidden_layers: Tuple[int, ...] = (512, 256),
        gno_max_neighbors: int = 32,
        gno_batched: bool = False,
        fno_n_modes: Tuple[int, ...] = (16, 16, 16),
        fno_hidden_channels: int = 64,
        fno_lifting_channel_ratio: int = 2,
        fno_n_layers: int = 4,
        fno_resolution_scaling_factor: Optional[float] = None,
        fno_block_precision: str = "full",
        fno_use_channel_mlp: bool = True,
        fno_channel_mlp_dropout: float = 0.0,
        fno_channel_mlp_expansion: float = 0.5,
        fno_non_linearity: Callable = gelu,
        fno_stabilizer: Optional[str] = None,
        fno_norm: Optional[str] = None,
        fno_norm_groups: int = 1,
        fno_ada_in_features: Optional[int] = None,
        fno_ada_in_dim: int = 1,
        fno_preactivation: bool = False,
        fno_skip: Optional[str] = "linear",
        fno_channel_mlp_skip: Optional[str] = "soft-gating",
        fno_separable: bool = False,
        fno_factorization: Optional[str] = None,
        fno_rank: float = 1.0,
        fno_fixed_rank_modes: bool = False,
        fno_implementation: str = "factorized",
        fno_conv_module: type = SpectralConv,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del gno_batched
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.in_coord_dim = len(fno_n_modes)
        self.fno_hidden_channels, self.fno_n_layers = fno_hidden_channels, fno_n_layers
        self.fno_norm = fno_norm
        self.fno_ada_in_features, self.fno_ada_in_dim = fno_ada_in_features, fno_ada_in_dim
        self.lifting = ChannelMLP(in_channels + self.in_coord_dim,
                                  out_channels=fno_hidden_channels,
                                  hidden_channels=fno_lifting_channel_ratio * fno_hidden_channels,
                                  n_layers=3, **kw)
        self.fno_blocks = FNOBlocks(
            fno_hidden_channels, fno_hidden_channels, tuple(fno_n_modes), n_layers=fno_n_layers,
            ada_in_features=ada_in_size(fno_norm, fno_ada_in_features, fno_ada_in_dim),
            resolution_scaling_factor=fno_resolution_scaling_factor,
            fno_block_precision=fno_block_precision, use_channel_mlp=fno_use_channel_mlp,
            channel_mlp_expansion=fno_channel_mlp_expansion,
            channel_mlp_dropout=fno_channel_mlp_dropout, non_linearity=fno_non_linearity,
            stabilizer=fno_stabilizer, norm=fno_norm, norm_groups=fno_norm_groups,
            preactivation=fno_preactivation, fno_skip=fno_skip,
            channel_mlp_skip=fno_channel_mlp_skip, separable=fno_separable,
            factorization=fno_factorization, rank=fno_rank,
            fixed_rank_modes=fno_fixed_rank_modes, implementation=fno_implementation,
            conv_module=fno_conv_module, **kw)
        weight_fn = None
        if gno_weighting_function is not None:
            weight_fn = dispatch_weighting_fn(gno_weighting_function,
                                              sq_radius=gno_radius ** 2,
                                              scale=gno_weight_function_scale)
        self.gno = GNOBlock(
            in_channels=fno_hidden_channels, out_channels=fno_hidden_channels,
            coord_dim=gno_coord_dim, radius=gno_radius, max_neighbors=gno_max_neighbors,
            weighting_fn=weight_fn, pos_embedding_type=gno_pos_embed_type,
            pos_embedding_channels=gno_embed_channels,
            pos_embedding_max_positions=gno_embed_max_positions,
            channel_mlp_layers=tuple(gno_channel_mlp_hidden_layers),
            transform_type=gno_transform_type, **kw)
        self.projection = ChannelMLP(fno_hidden_channels, out_channels=out_channels,
                                     hidden_channels=projection_channel_ratio
                                     * fno_hidden_channels,
                                     n_layers=2, non_linearity=fno_non_linearity, **kw)

    def latent_embedding(self, in_p, f, ada_in=None):
        """in_p (n1..nk, k) and f (b, n1..nk, c) or (n1..nk, c) -> the
        latent features (b, hidden, n1..nk) or (hidden, n1..nk)."""
        batched = f.ndim == self.in_coord_dim + 2
        if not batched:
            f = f[None]
        geo = in_p[None].expand(f.shape[0], *in_p.shape)
        h = torch.cat([f, geo], dim=-1)
        ndim = h.ndim
        h = h.permute(0, ndim - 1, *range(1, ndim - 1))
        embed = None
        if self.fno_norm == "ada_in":
            embed = ada_embed(ada_in, self.fno_ada_in_features, self.fno_ada_in_dim)
        h = self.lifting(h)
        for idx in range(self.fno_n_layers):
            h = self.fno_blocks(h, idx, ada_in_embedding=embed)
        return h if batched else h[0]

    def integrate_latent(self, in_p, out_p, latent_embed, neighbors=None):
        batched = latent_embed.ndim == self.in_coord_dim + 2
        k = self.in_coord_dim
        if batched:
            latent = latent_embed.permute(0, *range(2, k + 2), 1).reshape(
                latent_embed.shape[0], -1, self.fno_hidden_channels)
        else:
            latent = latent_embed.permute(*range(1, k + 1), 0).reshape(
                -1, self.fno_hidden_channels)
        out = self.gno(y=in_p.reshape(-1, in_p.shape[-1]), x=out_p, f_y=latent,
                       neighbors=neighbors)
        if out.ndim == 2:
            out = out[None]
        out = self.projection(out.permute(0, 2, 1))
        return out.permute(0, 2, 1) if batched else out[0].T

    def forward(self, in_p, out_p, f, ada_in=None, neighbors=None):
        latent_embed = self.latent_embedding(in_p=in_p, f=f, ada_in=ada_in)
        return self.integrate_latent(in_p=in_p, out_p=out_p, latent_embed=latent_embed,
                                     neighbors=neighbors)
