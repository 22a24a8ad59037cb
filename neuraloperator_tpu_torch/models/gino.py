"""GINO, the Geometry-Informed Neural Operator (port of
``neuraloperator_tpu/models/gino.py``).

A point cloud goes through the input GNO onto a latent regular grid, then
the lifting and the latent FNO blocks, then the output GNO to arbitrary
query points and the pointwise projection. Output queries may be a dict of
query sets; AdaIN conditions the FNO blocks on a scalar parameter.
Submodules keep the flax names (``gno_in``, ``lifting``, ``fno_blocks``,
``gno_out``, ``projection``).
"""

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .._common import resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.embeddings import SinusoidalEmbedding
from ..layers.fno_block import FNOBlocks
from ..layers.gno_block import GNOBlock
from ..layers.gno_weighting_functions import dispatch_weighting_fn
from ..layers.spectral_convolution import SpectralConv
from .base_model import register_model


def ada_in_size(norm, ada_in_features, ada_in_dim) -> Optional[int]:
    """The width of the AdaIN embedding the FNO blocks take (None without AdaIN)."""
    if norm != "ada_in":
        return None
    if ada_in_features is not None:
        return 2 * ada_in_dim * ada_in_features
    return ada_in_dim


def ada_embed(ada_in, ada_in_features, ada_in_dim, embedding_type="transformer"):
    """The AdaIN embedding of the parameter ``ada_in``: its sinusoidal
    embedding (``ada_in_features`` frequencies), or itself."""
    if ada_in is None:
        return None
    ada_in = ada_in.reshape(-1)
    if ada_in_features is None:
        return ada_in
    emb = SinusoidalEmbedding(in_channels=ada_in_dim, num_frequencies=ada_in_features,
                              embedding_type=embedding_type, max_positions=10000)
    return emb(ada_in[None, None, :]).reshape(-1)


@register_model(name="GINO")
class GINO(nn.Module):
    """``forward(input_geom, latent_queries, output_queries, x=None,
    latent_features=None, ada_in=None, in_neighbors=None, out_neighbors=None)``.

    ``input_geom`` (1, n, d) points, ``latent_queries`` (1, n1..nk, k) the
    latent grid, ``output_queries`` (n_out, d) or (1, n_out, d) points or a
    dict of them, ``x`` (b, n, in) features; returns (b, n_out, out) or a
    dict of them. ``in_neighbors``/``out_neighbors`` (a dict keyed as the
    queries for dict queries) are precomputed neighbourhoods; without them
    each GNO searches inside the call."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        latent_feature_channels: Optional[int] = None,
        projection_channel_ratio: int = 4,
        gno_coord_dim: int = 3,
        in_gno_radius: float = 0.033,
        out_gno_radius: float = 0.033,
        in_gno_transform_type: str = "linear",
        out_gno_transform_type: str = "linear",
        gno_weighting_function: Optional[str] = None,
        gno_weight_function_scale: float = 1.0,
        in_gno_pos_embed_type: Optional[str] = "transformer",
        out_gno_pos_embed_type: Optional[str] = "transformer",
        fno_in_channels: int = 3,
        fno_n_modes: Tuple[int, ...] = (16, 16, 16),
        fno_hidden_channels: int = 64,
        fno_lifting_channel_ratio: int = 2,
        fno_n_layers: int = 4,
        gno_embed_channels: int = 32,
        gno_embed_max_positions: int = 10000,
        in_gno_channel_mlp_hidden_layers: Tuple[int, ...] = (80, 80, 80),
        out_gno_channel_mlp_hidden_layers: Tuple[int, ...] = (512, 256),
        gno_max_neighbors: int = 32,
        out_gno_tanh: Optional[str] = None,
        fno_resolution_scaling_factor: Optional[float] = None,
        fno_block_precision: str = "full",
        fno_use_channel_mlp: bool = True,
        fno_channel_mlp_dropout: float = 0.0,
        fno_channel_mlp_expansion: float = 0.5,
        fno_non_linearity: Callable = gelu,
        fno_stabilizer: Optional[str] = None,
        fno_norm: Optional[str] = None,
        fno_norm_groups: int = 1,
        fno_ada_in_features: Optional[int] = 4,
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
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.in_coord_dim = len(fno_n_modes)
        self.fno_hidden_channels, self.fno_n_layers = fno_hidden_channels, fno_n_layers
        self.out_gno_tanh = out_gno_tanh
        self.fno_norm = fno_norm
        self.fno_ada_in_features, self.fno_ada_in_dim = fno_ada_in_features, fno_ada_in_dim
        self.out_gno_pos_embed_type = out_gno_pos_embed_type
        # nonlinear kernels keep the input channel count
        in_gno_out = (in_channels if in_gno_transform_type in ("nonlinear", "nonlinear_kernelonly")
                      else fno_in_channels)
        fno_in = in_gno_out + (latent_feature_channels or 0)
        self.gno_in = GNOBlock(
            in_channels=in_channels, out_channels=in_gno_out, coord_dim=gno_coord_dim,
            radius=in_gno_radius, max_neighbors=gno_max_neighbors, reduction="mean",
            weighting_fn=None, pos_embedding_type=in_gno_pos_embed_type,
            pos_embedding_channels=gno_embed_channels,
            pos_embedding_max_positions=gno_embed_max_positions,
            channel_mlp_layers=tuple(in_gno_channel_mlp_hidden_layers),
            transform_type=in_gno_transform_type, **kw)
        self.lifting = ChannelMLP(fno_in, out_channels=fno_hidden_channels,
                                  hidden_channels=fno_lifting_channel_ratio * fno_hidden_channels,
                                  n_layers=2, **kw)
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
                                              sq_radius=out_gno_radius ** 2,
                                              scale=gno_weight_function_scale)
        self.gno_out = GNOBlock(
            in_channels=fno_hidden_channels, out_channels=fno_hidden_channels,
            coord_dim=gno_coord_dim, radius=out_gno_radius, max_neighbors=gno_max_neighbors,
            reduction="sum", weighting_fn=weight_fn, pos_embedding_type=out_gno_pos_embed_type,
            pos_embedding_channels=gno_embed_channels,
            pos_embedding_max_positions=gno_embed_max_positions,
            channel_mlp_layers=tuple(out_gno_channel_mlp_hidden_layers),
            transform_type=out_gno_transform_type, **kw)
        self.projection = ChannelMLP(fno_hidden_channels, out_channels=out_channels,
                                     hidden_channels=projection_channel_ratio
                                     * fno_hidden_channels,
                                     n_layers=2, non_linearity=fno_non_linearity, **kw)

    def latent_embedding(self, in_p, ada_in=None):
        """(b, n1..nk, c) -> (b, hidden, n1..nk) through the lifting and the FNO."""
        ndim = in_p.ndim
        in_p = in_p.permute(0, ndim - 1, *range(1, ndim - 1))
        embed = None
        if self.fno_norm == "ada_in":
            embed = ada_embed(ada_in, self.fno_ada_in_features, self.fno_ada_in_dim,
                              self.out_gno_pos_embed_type or "transformer")
        in_p = self.lifting(in_p)
        for idx in range(self.fno_n_layers):
            in_p = self.fno_blocks(in_p, idx, ada_in_embedding=embed)
        return in_p

    def forward(self, input_geom, latent_queries, output_queries, x=None,
                latent_features=None, ada_in=None, in_neighbors=None, out_neighbors=None):
        batch_size = 1 if x is None else x.shape[0]
        input_geom = input_geom.reshape(-1, input_geom.shape[-1])
        lq_grid = (latent_queries.reshape(latent_queries.shape[1:])
                   if latent_queries.shape[0] == 1 else latent_queries)
        grid_shape = lq_grid.shape[:-1]
        lq_flat = lq_grid.reshape(-1, lq_grid.shape[-1])

        in_p = self.gno_in(y=input_geom, x=lq_flat, f_y=x, neighbors=in_neighbors)
        in_p = in_p.reshape(batch_size, *grid_shape, -1)
        if latent_features is not None:
            if latent_features.shape[0] != batch_size:
                latent_features = latent_features.expand(batch_size,
                                                         *latent_features.shape[1:])
            in_p = torch.cat([in_p, latent_features], dim=-1)

        latent_embed = self.latent_embedding(in_p, ada_in=ada_in)
        k = self.in_coord_dim
        latent_embed = latent_embed.permute(0, *range(2, k + 2), 1).reshape(
            batch_size, -1, self.fno_hidden_channels)
        if self.out_gno_tanh in ("latent_embed", "both"):
            latent_embed = torch.tanh(latent_embed)

        def query(out_p, neighbors):
            out_p = out_p.reshape(-1, out_p.shape[-1])
            sub = self.gno_out(y=lq_flat, x=out_p, f_y=latent_embed, neighbors=neighbors)
            sub = self.projection(sub.permute(0, 2, 1))
            return sub.permute(0, 2, 1)

        if isinstance(output_queries, dict):
            return {key: query(out_p, None if out_neighbors is None else out_neighbors.get(key))
                    for key, out_p in output_queries.items()}
        return query(output_queries, out_neighbors)
