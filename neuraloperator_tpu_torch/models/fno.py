"""Fourier Neural Operator and its Tucker-factorized variant (port of
``neuraloperator_tpu/models/fno.py``).

Grid embedding -> lifting ChannelMLP -> optional domain padding ->
``n_layers`` Fourier layers -> unpadding -> projection ChannelMLP; on
complex data the lifting and projection are ``ComplexValued`` pairs. The
layers are unrolled (``FNOBlocks``), or, with ``scan_layers``, one layer
over stacked parameters (``ScanFNOBlocks``); ``remat`` recomputes each
layer's activations in the backward. The constructor takes the JAX
module's fields, so a ``model_metadata.json`` builds either. ``TFNO`` is
the FNO with rank-0.1 Tucker weights by default, made by ``partialclass``
(a subclass with new defaults, as the JAX function makes one).
"""

import inspect
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .._common import resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.complex import ComplexValued
from ..layers.embeddings import GridEmbedding2D, GridEmbeddingND
from ..layers.fno_block import FNOBlocks
from ..layers.padding import domain_padding_or_none
from ..layers.scan_fno_block import ScanFNOBlocks, run_layer
from ..layers.spectral_convolution import SpectralConv
from .base_model import register_model


@register_model(name="FNO")
class FNO(nn.Module):
    """N-d FNO; ``forward(x)`` maps (b, in, d1..dN) -> (b, out, o1..oN).

    ``positional_embedding`` is "grid", None or a ``GridEmbeddingND`` /
    ``GridEmbedding2D`` instance, as in the JAX module. ``device`` defaults to ``"cuda"`` and raises when there is no card
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
        positional_embedding="grid",
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
        n_modes = tuple(int(m) for m in n_modes)
        # the mode counts, read by the incremental FNO trainer as the JAX
        # module's fields
        self.n_modes = n_modes
        self.max_n_modes = None if max_n_modes is None else tuple(int(m) for m in max_n_modes)
        self.n_layers = n_layers
        self.scan_layers = scan_layers
        self.remat = remat
        pe = positional_embedding
        if isinstance(pe, str) and pe == "grid":
            self.embedding = GridEmbeddingND(in_channels, dim=len(n_modes))
        elif isinstance(pe, GridEmbeddingND):
            if isinstance(pe, GridEmbedding2D) and len(n_modes) != 2:
                raise ValueError(f"expected {len(n_modes)}-d positional embedding, got 2-d")
            self.embedding = pe
        elif pe is None:
            self.embedding = None
        else:
            raise ValueError(
                f"positional_embedding must be 'grid', an embedding, or None; got {pe!r}"
            )
        self.domain_padding = domain_padding_or_none(domain_padding, resolution_scaling_factor)
        lifting_in = in_channels + (len(n_modes) if self.embedding is not None else 0)

        def lifting():
            return ChannelMLP(lifting_in, out_channels=hidden_channels,
                              hidden_channels=int(lifting_channel_ratio * hidden_channels),
                              n_layers=2, non_linearity=non_linearity, device=device,
                              generator=generator)

        def projection():
            return ChannelMLP(hidden_channels, out_channels=out_channels,
                              hidden_channels=int(projection_channel_ratio * hidden_channels),
                              n_layers=2, non_linearity=non_linearity, device=device,
                              generator=generator)

        self.lifting = ComplexValued(lifting) if complex_data else lifting()
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
        self.projection = ComplexValued(projection) if complex_data else projection()

    def forward(self, x: torch.Tensor, output_shape=None, n_modes=None,
                ada_in_embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``output_shape``: None, a tuple (the last layer's output size) or a
        list of per-layer sizes; ``n_modes``: a per-call mode count;
        ``ada_in_embedding``: the AdaIN norms' conditioning."""
        if output_shape is None:
            output_shapes = [None] * self.n_layers
        elif isinstance(output_shape, tuple):
            output_shapes = [None] * (self.n_layers - 1) + [output_shape]
        else:
            output_shapes = list(output_shape)
        if self.embedding is not None:
            x = self.embedding(x)
        x = self.lifting(x)
        if self.domain_padding is not None:
            x = self.domain_padding.pad(x)
        if self.scan_layers:
            if any(o is not None for o in output_shapes) or n_modes is not None:
                raise ValueError("scan_layers=True does not support per-call output_shape "
                                 "or n_modes overrides")
            x = self.fno_blocks(x)
        elif self.remat:
            params = dict(self.fno_blocks.named_parameters())
            for i in range(self.n_layers):
                x = run_layer(self.fno_blocks, params, x,
                              (i, output_shapes[i], ada_in_embedding, n_modes), remat=True)
        else:
            for i in range(self.n_layers):
                x = self.fno_blocks(x, i, output_shapes[i], ada_in_embedding, n_modes)
        if self.domain_padding is not None:
            x = self.domain_padding.unpad(x)
        return self.projection(x)


def partialclass(new_name: str, cls: type, **defaults) -> type:
    """A subclass of ``cls`` named ``new_name`` whose constructor takes
    ``cls``'s arguments with ``defaults`` as their new defaults (the JAX
    ``partialclass``): ``partialclass("MyFNO", FNO, factorization="tucker",
    rank=0.05)``. Raises ``TypeError`` for an argument ``cls`` does not
    take."""
    signature = inspect.signature(cls.__init__)
    for name in defaults:
        if name == "self" or name not in signature.parameters:
            raise TypeError(f"{cls.__name__} has no field {name!r}")
    signature = signature.replace(parameters=[
        p.replace(default=defaults[name]) if name in defaults else p
        for name, p in signature.parameters.items()
    ])

    def __init__(self, *args, **kwargs):
        bound = signature.bind(self, *args, **kwargs)
        bound.apply_defaults()
        del bound.arguments["self"]
        cls.__init__(self, **bound.arguments)

    __init__.__signature__ = signature
    return type(new_name, (cls,), {"__init__": __init__, "__doc__": cls.__doc__})


TFNO = register_model(name="TFNO")(
    partialclass("TFNO", FNO, factorization="tucker", rank=0.1))
TFNO.__doc__ = """Tucker-factorized FNO: ``factorization="tucker"`` and ``rank=0.1`` by
default, the FNO's arguments otherwise (the JAX ``TFNO``)."""
