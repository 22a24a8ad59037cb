"""Fourier Neural Operator (port of ``neuraloperator_tpu/models/fno.py``).

Grid embedding -> lifting ChannelMLP -> ``n_layers`` Fourier layers ->
projection ChannelMLP. The layers are unrolled (``FNOBlocks``), or, with
``scan_layers``, one layer over stacked parameters (``ScanFNOBlocks``);
``remat`` recomputes each layer's activations in the backward. The
constructor takes the JAX module's fields, so a ``model_metadata.json``
builds either.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .._common import not_ported, resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.embeddings import GridEmbeddingND
from ..layers.fno_block import FNOBlocks
from ..layers.scan_fno_block import ScanFNOBlocks, run_layer
from ..layers.spectral_convolution import SpectralConv
from .base_model import register_model


@register_model(name="FNO")
class FNO(nn.Module):
    """N-d FNO over real data; ``forward(x)`` maps (b, in, d1..dN) -> (b, out, d1..dN).

    ``device`` defaults to ``"cuda"`` and raises when there is no card
    unless ``device="cpu"`` is passed. Weights are drawn on the CPU from
    ``generator`` (torch's default generator when None), then moved.
    """

    def __init__(
        self,
        n_modes: Sequence[int],
        in_channels: int,
        out_channels: int,
        hidden_channels: int,
        n_layers: int = 4,
        lifting_channel_ratio: float = 2,
        projection_channel_ratio: float = 2,
        positional_embedding: Optional[str] = "grid",
        non_linearity: Callable = gelu,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        complex_data: bool = False,
        use_channel_mlp: bool = True,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        channel_mlp_skip: Optional[str] = "soft-gating",
        fno_skip: Optional[str] = "linear",
        conv_bias_kernel: int = 1,
        resolution_scaling_factor=None,
        domain_padding=None,
        fno_block_precision: str = "full",
        stabilizer: Optional[str] = None,
        max_n_modes: Optional[Sequence[int]] = None,
        factorization: Optional[str] = None,
        rank=1.0,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        decomposition_kwargs: Optional[dict] = None,
        separable: bool = False,
        preactivation: bool = False,
        conv_module: type = SpectralConv,
        enforce_hermitian_symmetry: bool = True,
        weight_dtype: str = "float32",
        scan_layers: bool = False,
        remat: bool = False,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if scan_layers:
            unsupported = {
                "norm": norm is not None,
                "preactivation": preactivation,
                "stabilizer": stabilizer is not None,
                "resolution_scaling_factor": resolution_scaling_factor is not None,
                "complex_data": complex_data,
                "factorization": factorization is not None,
                "separable": separable,
                "conv_bias_kernel>1": conv_bias_kernel != 1,
                "use_channel_mlp=False": not use_channel_mlp,
                "fno_skip=None": fno_skip is None,
                "channel_mlp_skip=None": channel_mlp_skip is None,
            }
            bad = [k for k, v in unsupported.items() if v]
            if bad:
                raise ValueError(
                    f"scan_layers=True does not support: {', '.join(bad)}; "
                    "use the unrolled FNOBlocks path"
                )
        if complex_data:
            raise not_ported("FNO complex_data=True", "the other families")
        if domain_padding is not None and domain_padding != 0:
            raise not_ported("FNO domain_padding", "the other families")
        n_modes = tuple(int(m) for m in n_modes)
        self.n_layers = n_layers
        self.scan_layers = scan_layers
        self.remat = remat
        if positional_embedding == "grid":
            self.embedding = GridEmbeddingND(in_channels, dim=len(n_modes))
        elif positional_embedding is None:
            self.embedding = None
        else:
            raise not_ported(
                f"FNO positional_embedding={positional_embedding!r}", "the other families"
            )
        lifting_in = in_channels + (len(n_modes) if self.embedding is not None else 0)
        self.lifting = ChannelMLP(
            lifting_in,
            out_channels=hidden_channels,
            hidden_channels=int(lifting_channel_ratio * hidden_channels),
            n_layers=2,
            non_linearity=non_linearity,
            device=device,
            generator=generator,
        )
        if scan_layers:
            # the JAX _ScanLayer builds its layers with these fields alone
            self.fno_blocks = ScanFNOBlocks(
                hidden_channels,
                hidden_channels,
                n_modes,
                n_layers=n_layers,
                fno_skip=fno_skip,
                channel_mlp_skip=channel_mlp_skip,
                channel_mlp_expansion=channel_mlp_expansion,
                non_linearity=non_linearity,
                max_n_modes=max_n_modes,
                weight_dtype=weight_dtype,
                remat=remat,
                device=device,
                generator=generator,
            )
        else:
            self.fno_blocks = FNOBlocks(
                hidden_channels,
                hidden_channels,
                n_modes,
                resolution_scaling_factor=resolution_scaling_factor,
                n_layers=n_layers,
                max_n_modes=max_n_modes,
                fno_block_precision=fno_block_precision,
                use_channel_mlp=use_channel_mlp,
                channel_mlp_dropout=channel_mlp_dropout,
                channel_mlp_expansion=channel_mlp_expansion,
                non_linearity=non_linearity,
                stabilizer=stabilizer,
                norm=norm,
                norm_groups=norm_groups,
                preactivation=preactivation,
                fno_skip=fno_skip,
                conv_bias_kernel=conv_bias_kernel,
                channel_mlp_skip=channel_mlp_skip,
                complex_data=complex_data,
                separable=separable,
                factorization=factorization,
                rank=rank,
                conv_module=conv_module,
                fixed_rank_modes=fixed_rank_modes,
                implementation=implementation,
                decomposition_kwargs=decomposition_kwargs,
                enforce_hermitian_symmetry=enforce_hermitian_symmetry,
                weight_dtype=weight_dtype,
                device=device,
                generator=generator,
            )
        self.projection = ChannelMLP(
            hidden_channels,
            out_channels=out_channels,
            hidden_channels=int(projection_channel_ratio * hidden_channels),
            n_layers=2,
            non_linearity=non_linearity,
            device=device,
            generator=generator,
        )

    def forward(self, x: torch.Tensor, output_shape=None, n_modes=None) -> torch.Tensor:
        """``output_shape`` and ``n_modes`` (the JAX per-call overrides) must be None."""
        if output_shape is not None or n_modes is not None:
            if self.scan_layers:
                raise ValueError("scan_layers=True does not support per-call output_shape "
                                 "or n_modes overrides")
            raise not_ported("FNO per-call output_shape/n_modes", "the other families")
        if self.embedding is not None:
            x = self.embedding(x)
        x = self.lifting(x)
        if self.scan_layers:
            x = self.fno_blocks(x)
        elif self.remat:
            params = dict(self.fno_blocks.named_parameters())
            for i in range(self.n_layers):
                x = run_layer(self.fno_blocks, params, x, (i,), remat=True)
        else:
            for i in range(self.n_layers):
                x = self.fno_blocks(x, i)
        return self.projection(x)
