"""Spectral convolution (port of ``neuraloperator_tpu/layers/spectral_convolution.py``).

Ported branch: real data, Hermitian symmetry enforced, every axis at most
512 points, ``fno_block_precision`` "full", "half" or "mixed",
``weight_dtype`` "float32" or "bfloat16"; dense, CP, Tucker or TT weights
(``factorization``, ``rank``, ``fixed_rank_modes``), contracted
``"factorized"`` or ``"reconstructed"`` (``implementation``), separable or
not. The forward is

1. ``rdft_gather_last`` along the last axis, then ``dft_gather_axis`` on
   each earlier axis (truncated DFT matmuls);
2. the per-mode complex contraction (``ops/contractions.contract_block``):
   a dense weight, or one rebuilt from its factors (``"reconstructed"``),
   through ``contract_dense`` (the CUDA kernels on the card), factors
   through the complex einsums of ``contract_cp/tucker/tt``;
3. ``_shrink_centered``, ``dft_scatter_axis`` on the earlier axes, then
   ``rdft_scatter_last`` (inverse DFT matmuls with structural Hermitian
   enforcement);
4. the bias.

"full" computes in float32 whatever the input's dtype. "half" and "mixed"
round where the JAX function rounds: "half" first rounds x through
bfloat16; both run the forward DFTs on bfloat16 x, contract bfloat16
operands with float32 sums (the kernels' bf16 variants; bf16 products of
the einsums), round the contraction's output to bfloat16 for the inverse
DFTs, and return bfloat16 (the last inverse sums in float32, then rounds),
the bias added in it.

Weights keep the JAX storage layout and names: one parameter per factor,
``w_weight`` (dense, ``(2, in, out, m1..mN)``; ``(2, in, m1..mN)``
separable), or ``w_core``/``w_lambdas`` and ``w_factor_0..N``, each with
the real and imaginary parts stacked on a leading axis of 2, stored as
``weight_dtype`` and read as float32; ``bias`` is ``(out, 1, .., 1)``,
float32, cast to the output's dtype where it is added.
"""

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .._common import not_ported, resolve_device
from ..ops.contractions import contract_block
from ..ops.fourier import (
    dft_gather_axis,
    dft_scatter_axis,
    rdft_gather_last,
    rdft_scatter_last,
    resolve_weight_slices,
)
from ..tensor.factorized import FactorizationSpec, init_factors, resolve_spec, slice_factors
from . import _init

# inputs wider than this go through an FFT in the JAX package
MAX_DFT_AXIS = 512


def halve_last_mode(n_modes: Sequence[int], complex_data: bool) -> List[int]:
    """rfft redundancy: keep ``m//2 + 1`` modes along the last dim."""
    n_modes = [int(m) for m in (
        [n_modes] if isinstance(n_modes, int) else list(n_modes)
    )]
    if not complex_data:
        n_modes[-1] = n_modes[-1] // 2 + 1
    return n_modes


PRECISIONS = ("full", "half", "mixed")
IMPLEMENTATIONS = ("reconstructed", "factorized")
WEIGHT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SpectralConv(nn.Module):
    """N-dimensional spectral convolution over real data."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_modes: Sequence[int],
        complex_data: bool = False,
        max_n_modes: Optional[Sequence[int]] = None,
        use_bias: bool = True,
        separable: bool = False,
        resolution_scaling_factor=None,
        fno_block_precision: str = "full",
        rank: Union[float, Tuple[int, ...]] = 1.0,
        factorization: Optional[str] = None,
        implementation: str = "reconstructed",
        enforce_hermitian_symmetry: bool = True,
        fixed_rank_modes: bool = False,
        init_std: Union[str, float] = "auto",
        fft_norm: str = "forward",
        weight_dtype: str = "float32",
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if complex_data:
            raise not_ported("SpectralConv complex_data=True", "the other families")
        if fno_block_precision not in PRECISIONS:
            raise ValueError(
                f"fno_block_precision must be one of {PRECISIONS}, got {fno_block_precision!r}"
            )
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype must be 'float32' or 'bfloat16', got {weight_dtype!r}"
            )
        if implementation not in IMPLEMENTATIONS:
            raise ValueError(
                f"implementation must be 'reconstructed' or 'factorized', got {implementation}"
            )
        if resolution_scaling_factor is not None:
            raise not_ported("SpectralConv resolution_scaling_factor", "the other families")
        if not enforce_hermitian_symmetry:
            raise not_ported(
                "SpectralConv enforce_hermitian_symmetry=False", "the other families"
            )
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_modes = tuple(
            [n_modes] if isinstance(n_modes, int) else [int(m) for m in n_modes]
        )
        self.fft_norm = fft_norm
        self.fno_block_precision = fno_block_precision
        self.separable = separable
        self.implementation = implementation
        halved = halve_last_mode(self.n_modes, complex_data=False)
        if max_n_modes is None:
            self.max_n_modes = halved
        else:
            self.max_n_modes = (
                [int(max_n_modes)] if isinstance(max_n_modes, int)
                else [int(m) for m in max_n_modes]
            )
        if separable:
            if in_channels != out_channels:
                raise ValueError(
                    "separable SpectralConv requires in_channels == out_channels,"
                    f" got {in_channels} != {out_channels}"
                )
            weight_shape = (in_channels, *self.max_n_modes)
        else:
            weight_shape = (in_channels, out_channels, *self.max_n_modes)
        fixed = [0] if fixed_rank_modes is True else (fixed_rank_modes or None)
        self.spec = resolve_spec(factorization, weight_shape, rank, fixed)
        if init_std == "auto":
            std = (2 / (in_channels + out_channels)) ** 0.5
        else:
            std = float(init_std)
        device = resolve_device(device)
        # one (2, ...) parameter per factor, named as the JAX module names it
        self.factor_names = []
        for name, param in init_factors(self.spec, std, device, generator,
                                        WEIGHT_DTYPES[weight_dtype]).items():
            self.register_parameter(f"w_{name}", param)
            self.factor_names.append(name)
        self.bias = (
            _init.normal((out_channels,) + (1,) * len(self.n_modes), std, device, generator)
            if use_bias else None
        )

    def factors(self):
        """``{name: (re, im)}`` of the stored factors, read as float32; a
        dense weight under "half" or "mixed" is left in its storage dtype,
        which the contraction casts to bf16 anyway."""
        keep = (self.spec.kind == "dense" and not self.separable
                and self.fno_block_precision in ("half", "mixed"))
        out = {}
        for name in self.factor_names:
            w = getattr(self, f"w_{name}")
            w = w if keep else w.float()
            out[name] = (w[0], w[1])
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spectral_conv_forward(
            x,
            self.spec,
            self.factors(),
            self.bias,
            n_modes=halve_last_mode(self.n_modes, complex_data=False),
            max_n_modes=self.max_n_modes,
            separable=self.separable,
            implementation=self.implementation,
            fft_norm=self.fft_norm,
            fno_block_precision=self.fno_block_precision,
        )

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Resample a skip branch to this layer's output resolution.

        Without resolution scaling the output resolution is the input's,
        so this is the identity.
        """
        return x


def spectral_conv_forward(
    x: torch.Tensor,
    spec: FactorizationSpec,
    params,
    bias: Optional[torch.Tensor],
    *,
    n_modes: Sequence[int],
    max_n_modes: Sequence[int],
    separable: bool = False,
    implementation: str = "reconstructed",
    fft_norm: str = "forward",
    fno_block_precision: str = "full",
) -> torch.Tensor:
    """Functional core: x (b, in, d1..dN), the weight's ``spec`` and its
    factors ``params`` (``{name: (re, im)}``).

    ``n_modes`` has the last dim already halved (``halve_last_mode``).
    """
    order = len(n_modes)
    mode_sizes = list(x.shape[2:])
    if len(mode_sizes) != order:
        raise ValueError(
            f"input has {len(mode_sizes)} spatial dims but n_modes has {order}"
        )
    if max(mode_sizes) > MAX_DFT_AXIS:
        raise not_ported(
            f"SpectralConv on axes over {MAX_DFT_AXIS} points (the FFT path)",
            "the other families",
        )
    # "half" and "mixed": bf16 operands with f32 sums, rounded where the
    # JAX function rounds. On real data the two are one path: "half"'s
    # rounding of x through bf16 is the cast of the DFT input.
    mixed = fno_block_precision in ("half", "mixed")
    x = x.to(torch.bfloat16 if mixed else torch.float32)

    fft_size = list(mode_sizes)
    fft_size[-1] = fft_size[-1] // 2 + 1
    axes = list(range(-order, 0))

    # active modes sit at the centre of the stored weight (start of the
    # last dim); the slices index its (in, out, modes...) dims
    slices = resolve_weight_slices(
        fft_size, n_modes, max_n_modes, separable=separable, complex_data=False
    )
    spec, params = slice_factors(spec, params, slices)
    kept = list(spec.shape[1 if separable else 2:])

    kept_last = min(kept[-1], fft_size[-1])
    br, bi = rdft_gather_last(x, kept_last, fft_norm)
    for i, ax in enumerate(axes[:-1]):
        br, bi = dft_gather_axis(br, bi, min(kept[i], mode_sizes[i]), ax, fft_norm)
    if kept_last < kept[-1]:
        # weight wider than the spectrum: trim its last-mode factor
        trim = [slice(None)] * spec.order
        trim[-1] = slice(0, kept_last)
        spec, params = slice_factors(spec, params, trim)

    out_r, out_i = contract_block((br, bi), spec, params, separable=separable,
                                  implementation=implementation,
                                  compute_dtype=torch.bfloat16 if mixed else None)

    half = mode_sizes[-1] // 2 + 1
    out_r = _shrink_centered(out_r, mode_sizes[:-1], axes[:-1])
    out_i = _shrink_centered(out_i, mode_sizes[:-1], axes[:-1])
    out_r = out_r[..., : min(out_r.shape[-1], half)]
    out_i = out_i[..., : min(out_i.shape[-1], half)]
    if mixed:
        out_r, out_i = out_r.to(torch.bfloat16), out_i.to(torch.bfloat16)
    for i, ax in enumerate(axes[:-1]):
        out_r, out_i = dft_scatter_axis(out_r, out_i, mode_sizes[i], ax, fft_norm)
    y = rdft_scatter_last(out_r, out_i, mode_sizes[-1], fft_norm)
    if mixed:
        y = y.to(torch.bfloat16)
    if bias is not None:
        y = y + bias[None].to(y.dtype)
    return y


def _shrink_centered(
    block: torch.Tensor, target_sizes: Sequence[int], axes: Sequence[int]
) -> torch.Tensor:
    """Truncate a centered-order mode block so it fits the target spectrum."""
    for size, ax in zip(target_sizes, axes):
        kept = block.shape[ax]
        if kept <= size:
            continue
        neg = kept // 2
        new_neg, new_pos = size // 2, size // 2 + size % 2
        block = block.narrow(ax, neg - new_neg, new_neg + new_pos)
    return block
