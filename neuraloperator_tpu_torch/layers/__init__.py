from .channel_mlp import ChannelMLP, gelu
from .embeddings import GridEmbeddingND, regular_grid_nd
from .fno_block import FNOBlocks
from .skip_connections import Flattened1dConv, SoftGating, skip_connection
from .spectral_convolution import SpectralConv, halve_last_mode, spectral_conv_forward

__all__ = [
    "ChannelMLP", "FNOBlocks", "Flattened1dConv", "GridEmbeddingND", "SoftGating",
    "SpectralConv", "gelu", "halve_last_mode", "regular_grid_nd", "skip_connection",
    "spectral_conv_forward",
]
