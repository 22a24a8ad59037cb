"""Spectral convolution (port of ``neuraloperator_tpu/layers/spectral_convolution.py``).

Ported branch: real data, dense weights, Hermitian symmetry enforced, every
axis at most 512 points, ``fno_block_precision`` "full", "half" or "mixed",
``weight_dtype`` "float32" or "bfloat16". The forward is

1. ``rdft_gather_last`` along the last axis, then ``dft_gather_axis`` on
   each earlier axis (truncated DFT matmuls);
2. the per-mode complex contraction (``ops/contractions.contract_dense``,
   the CUDA kernel on the card);
3. ``_shrink_centered``, ``dft_scatter_axis`` on the earlier axes, then
   ``rdft_scatter_last`` (inverse DFT matmuls with structural Hermitian
   enforcement);
4. the bias.

"full" computes in float32 whatever the input's dtype. "half" and "mixed"
round where the JAX function rounds: "half" first rounds x through
bfloat16; both run the forward DFTs on bfloat16 x, contract bfloat16
operands with float32 sums (the kernels' bf16 variants), round the
contraction's output to bfloat16 for the inverse DFTs, and return bfloat16
(the last inverse sums in float32, then rounds), the bias added in it.

Weights keep the JAX storage layout: ``w_weight`` is ``(2, in, out, m1..mN)``
(real and imaginary parts stacked), stored as ``weight_dtype`` and read as
float32; ``bias`` is ``(out, 1, .., 1)``, float32, cast to the output's
dtype where it is added.
"""

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .._common import not_ported, resolve_device
from ..ops.contractions import contract_dense
from ..ops.fourier import (
    dft_gather_axis,
    dft_scatter_axis,
    rdft_gather_last,
    rdft_scatter_last,
    resolve_weight_slices,
)
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
WEIGHT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SpectralConv(nn.Module):
    """N-dimensional spectral convolution over real data with dense weights."""

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
        del rank, fixed_rank_modes, implementation  # dense weights only
        if complex_data:
            raise not_ported("SpectralConv complex_data=True", "the other families")
        if separable:
            raise not_ported("SpectralConv separable=True", "the other families")
        if factorization is not None:
            raise not_ported(
                f"SpectralConv factorization={factorization!r}", "the other families"
            )
        if fno_block_precision not in PRECISIONS:
            raise ValueError(
                f"fno_block_precision must be one of {PRECISIONS}, got {fno_block_precision!r}"
            )
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype must be 'float32' or 'bfloat16', got {weight_dtype!r}"
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
        halved = halve_last_mode(self.n_modes, complex_data=False)
        if max_n_modes is None:
            self.max_n_modes = halved
        else:
            self.max_n_modes = (
                [int(max_n_modes)] if isinstance(max_n_modes, int)
                else [int(m) for m in max_n_modes]
            )
        if init_std == "auto":
            std = (2 / (in_channels + out_channels)) ** 0.5
        else:
            std = float(init_std)
        device = resolve_device(device)
        shape = (2, in_channels, out_channels, *self.max_n_modes)
        # dense init of the JAX package (tensor/factorized.py:init_factors):
        # real and imaginary parts each N(0, (std / sqrt 2)^2)
        self.w_weight = _init.normal(shape, std / 2 ** 0.5, device, generator,
                                     WEIGHT_DTYPES[weight_dtype])
        self.bias = (
            _init.normal((out_channels,) + (1,) * len(self.n_modes), std, device, generator)
            if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spectral_conv_forward(
            x,
            self.w_weight,
            self.bias,
            n_modes=halve_last_mode(self.n_modes, complex_data=False),
            max_n_modes=self.max_n_modes,
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
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    n_modes: Sequence[int],
    max_n_modes: Sequence[int],
    fft_norm: str = "forward",
    fno_block_precision: str = "full",
) -> torch.Tensor:
    """Functional core: x (b, in, d1..dN), weight (2, in, out, m1..mN).

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
        fft_size, n_modes, max_n_modes, separable=False, complex_data=False
    )
    w = weight[(slice(None), *slices)]
    if not mixed:
        w = w.float()  # bf16 storage is read as f32; "mixed" casts it for the contraction
    kept = list(w.shape[3:])

    kept_last = min(kept[-1], fft_size[-1])
    br, bi = rdft_gather_last(x, kept_last, fft_norm)
    for i, ax in enumerate(axes[:-1]):
        br, bi = dft_gather_axis(br, bi, min(kept[i], mode_sizes[i]), ax, fft_norm)
    if kept_last < kept[-1]:
        # weight wider than the spectrum: trim its last-mode entries
        w = w[..., :kept_last]

    out_r, out_i = contract_dense((br, bi), (w[0], w[1]),
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
