from .channel_mlp import ChannelMLP, gelu
from .coda_layer import CODALayer
from .differential_conv import FiniteDifferenceConvolution
from .discrete_continuous_convolution import (
    DiscreteContinuousConv2d,
    DiscreteContinuousConvTranspose2d,
    EquidistantDiscreteContinuousConv2d,
    EquidistantDiscreteContinuousConvTranspose2d,
    equidistant_filter_basis,
    precompute_filter_matrix,
)
from .embeddings import GridEmbeddingND, regular_grid_nd
from .fno_block import FNOBlocks
from .local_no_block import LocalNOBlocks
from .skip_connections import Flattened1dConv, SoftGating, skip_connection
from .spectral_convolution import SpectralConv, halve_last_mode, spectral_conv_forward

__all__ = [
    "CODALayer", "ChannelMLP", "DiscreteContinuousConv2d", "DiscreteContinuousConvTranspose2d",
    "EquidistantDiscreteContinuousConv2d", "EquidistantDiscreteContinuousConvTranspose2d",
    "FNOBlocks", "FiniteDifferenceConvolution", "Flattened1dConv", "GridEmbeddingND",
    "LocalNOBlocks", "SoftGating", "SpectralConv", "equidistant_filter_basis", "gelu",
    "halve_last_mode", "precompute_filter_matrix", "regular_grid_nd", "skip_connection",
    "spectral_conv_forward",
]
