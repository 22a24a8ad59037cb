"""GNOBlock: neighbour search, positional embedding and integral transform
(port of ``neuraloperator_tpu/layers/gno_block.py``).

The neighbourhoods are either passed in (``neighbors=``, a padded or CSR
dict) or searched inside the call by
:func:`~.neighbor_search.padded_neighbor_search` with the static
``max_neighbors`` budget, as the JAX block searches inside its jitted call.
"""

from typing import Callable, List, Optional

import torch
from torch import nn

from .channel_mlp import gelu
from .embeddings import SinusoidalEmbedding
from .integral_transform import IntegralTransform
from .neighbor_search import padded_neighbor_search


class GNOBlock(nn.Module):
    """``forward(y, x, f_y=None, neighbors=None)``: y (n, coord_dim) input
    points, x (m, coord_dim) queries, f_y (n, in) or (b, n, in) features;
    returns (m, out) or (b, m, out). The kernel MLP's layers are
    ``channel_mlp_layers`` with the embedded pair's width put first
    (``2 * coord_dim * 2 * pos_embedding_channels`` for a sinusoidal
    embedding, plus ``in_channels`` for the nonlinear types) and
    ``out_channels`` last, unless they are there already."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        coord_dim: int,
        radius: float,
        max_neighbors: int = 32,
        transform_type: str = "linear",
        weighting_fn: Optional[Callable] = None,
        reduction: str = "sum",
        pos_embedding_type: Optional[str] = "transformer",
        pos_embedding_channels: int = 32,
        pos_embedding_max_positions: int = 10000,
        channel_mlp_layers=(128, 256, 128),
        channel_mlp_non_linearity: Optional[Callable] = None,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.coord_dim, self.radius = coord_dim, radius
        self.max_neighbors = max_neighbors
        self.transform_type = transform_type
        self.weighting_fn = weighting_fn
        self.pos_embedding = None
        if pos_embedding_type in ("nerf", "transformer"):
            self.pos_embedding = SinusoidalEmbedding(
                in_channels=coord_dim, num_frequencies=pos_embedding_channels,
                embedding_type=pos_embedding_type,
                max_positions=pos_embedding_max_positions)
        self.integral_transform = IntegralTransform(
            channel_mlp_layers=tuple(self._kernel_layers(channel_mlp_layers)),
            channel_mlp_non_linearity=channel_mlp_non_linearity or gelu,
            transform_type=transform_type, weighting_fn=weighting_fn, reduction=reduction,
            device=device, generator=generator)

    def _kernel_layers(self, channel_mlp_layers) -> List[int]:
        emb = self.pos_embedding
        kernel_in = emb.out_channels * 2 if emb is not None else self.coord_dim * 2
        if self.transform_type in ("nonlinear", "nonlinear_kernelonly"):
            kernel_in += self.in_channels
        layers = list(channel_mlp_layers)
        if layers[0] != kernel_in:
            layers = [kernel_in] + layers
        if layers[-1] != self.out_channels:
            layers = layers + [self.out_channels]
        return layers

    def forward(self, y, x, f_y=None, neighbors=None):
        if neighbors is None:
            neighbors = padded_neighbor_search(y, x, self.radius, self.max_neighbors,
                                               return_norm=self.weighting_fn is not None)
        if self.pos_embedding is not None:
            y_embed, x_embed = self.pos_embedding(y), self.pos_embedding(x)
        else:
            y_embed, x_embed = y, x
        return self.integral_transform(y=y_embed, neighbors=neighbors, x=x_embed, f_y=f_y)
