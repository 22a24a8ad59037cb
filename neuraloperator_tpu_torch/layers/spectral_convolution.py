"""Spectral convolution (port of ``neuraloperator_tpu/layers/spectral_convolution.py``).

Every branch of the JAX layer: real or complex data, ``fno_block_precision``
"full", "half" or "mixed", ``weight_dtype`` "float32" or "bfloat16"; dense,
CP, Tucker or TT weights (``factorization``, ``rank``,
``fixed_rank_modes``), contracted ``"factorized"`` or ``"reconstructed"``
(``implementation``), separable or not; ``resolution_scaling_factor``, a
per-call ``output_shape`` and ``n_modes``; Hermitian symmetry enforced or
not. The forward on real data is

1. along the last axis ``rdft_gather_last`` (a truncated DFT matmul), or,
   over 512 points, ``torch.fft.rfft`` (cuFFT on the card) and a slice of
   its low modes; then ``dft_gather_axis`` on each earlier axis, at any size;
2. the per-mode complex contraction (``ops/contractions.contract_block``):
   a dense weight, or one rebuilt from its factors (``"reconstructed"``),
   through ``contract_dense`` (the CUDA kernels on the card), factors
   through the complex einsums of ``contract_cp/tucker/tt``;
3. ``_shrink_centered`` to the output size, ``dft_scatter_axis`` on the
   earlier axes, then ``rdft_scatter_last`` (structural Hermitian
   enforcement), or, when the output's last axis is over 512 points or the
   symmetry is not enforced, ``ops/fourier.irfft_hermitian`` over the last
   axis (the DC and even-size Nyquist imaginary parts zeroed when
   enforcing, then ``torch.fft.irfft``);
4. the bias.

On complex data the spectrum is ``torch.fft.fftn`` over every spatial axis,
its centered block gathered (``gather_center_modes``), contracted, shrunk,
scattered back (``scatter_center_modes``) and inverted by ``ifftn``; the
output is complex. Both FFT branches reach the same contraction as the
DFT path, so the contraction kernels run on every branch.

"full" computes in float32 whatever the input's dtype. "half" and "mixed"
round where the JAX function rounds: "half" first rounds x through
bfloat16 (the real part of complex x, as JAX's cast keeps it); the DFT
path runs its forward matmuls on bfloat16 x, the rFFT path transforms x in
float32 and rounds the kept modes to bfloat16, the complex path rounds the
whole spectrum through bfloat16; all contract bfloat16 operands with
float32 sums (the kernels' bf16 variants; bf16 products of the einsums),
round the contraction's output to bfloat16 on real data, and return
bfloat16 (on complex data the real part, as JAX's cast of a complex result
to bfloat16 keeps it), the bias added in it.

Weights keep the JAX storage layout and names: one parameter per factor,
``w_weight`` (dense, ``(2, in, out, m1..mN)``; ``(2, in, m1..mN)``
separable), or ``w_core``/``w_lambdas`` and ``w_factor_0..N``, each with
the real and imaginary parts stacked on a leading axis of 2, stored as
``weight_dtype`` and read as float32; ``bias`` is ``(out, 1, .., 1)``,
float32, cast to the output's dtype where it is added.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from .._common import resolve_device
from ..ops.contractions import contract_block
from ..ops.fourier import (
    dft_gather_axis,
    dft_scatter_axis,
    gather_center_modes,
    irfft_hermitian,
    rdft_gather_last,
    rdft_scatter_last,
    resolve_weight_slices,
    scatter_center_modes,
)
from ..parallel.comm import copy_to_model_parallel_region, gather_from_model_parallel_region
from ..tensor.factorized import FactorizationSpec, init_factors, resolve_spec, slice_factors
from ..utils import validate_scaling_factor
from . import _init
from .resample import resample

# a last axis wider than this goes through an FFT in the JAX package; earlier
# axes take the DFT matmul at any size
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
    """N-dimensional spectral convolution; ``forward(x, output_shape=None,
    n_modes=None)`` takes the JAX layer's per-call overrides.

    ``model_group`` (a ``parallel.comm.SharedGroup``, set by
    ``parallel.mesh.shard_params``): the process group over which a dense
    weight's contraction is split by out channels, each rank contracting
    with its slice and the outputs all-gathered.
    """

    model_group = None

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
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_modes = tuple(
            [n_modes] if isinstance(n_modes, int) else [int(m) for m in n_modes]
        )
        self.fft_norm = fft_norm
        self.fno_block_precision = fno_block_precision
        self.separable = separable
        self.implementation = implementation
        self.complex_data = complex_data
        self.enforce_hermitian_symmetry = enforce_hermitian_symmetry
        self.resolution_scaling_factor = validate_scaling_factor(
            resolution_scaling_factor, len(self.n_modes))
        halved = halve_last_mode(self.n_modes, complex_data)
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

    def forward(self, x: torch.Tensor, output_shape: Optional[Sequence[int]] = None,
                n_modes: Optional[Sequence[int]] = None) -> torch.Tensor:
        spec, factors = self.spec, self.factors()
        group = None if self.model_group is None else self.model_group.group
        if group is not None:
            # this rank's out channels of the dense weight (in, out, modes...)
            chunk = self.out_channels // dist.get_world_size(group)
            start = dist.get_rank(group) * chunk
            factors = {"weight": tuple(t.narrow(1, start, chunk) for t in factors["weight"])}
            spec = dataclasses.replace(spec, shape=(spec.shape[0], chunk, *spec.shape[2:]))
        return spectral_conv_forward(
            x,
            spec,
            factors,
            self.bias,
            n_modes=halve_last_mode(self.n_modes if n_modes is None else n_modes,
                                    self.complex_data),
            max_n_modes=self.max_n_modes,
            complex_data=self.complex_data,
            separable=self.separable,
            implementation=self.implementation,
            fft_norm=self.fft_norm,
            fno_block_precision=self.fno_block_precision,
            enforce_hermitian_symmetry=self.enforce_hermitian_symmetry,
            resolution_scaling_factor=self.resolution_scaling_factor,
            output_shape=output_shape,
            model_group=group,
        )

    def transform(self, x: torch.Tensor,
                  output_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Resample a skip branch to this layer's output resolution
        (``layers/resample.py``); the identity when the size does not change."""
        in_shape = tuple(x.shape[2:])
        rsf = self.resolution_scaling_factor
        if output_shape is not None:
            out_shape = tuple(output_shape)
        elif rsf is not None:
            out_shape = tuple(round(s * r) for s, r in zip(in_shape, rsf))
        else:
            out_shape = in_shape
        if in_shape == out_shape:
            return x
        return resample(x, 1.0, list(range(2, x.ndim)), output_shape=out_shape)


def spectral_conv_forward(
    x: torch.Tensor,
    spec: FactorizationSpec,
    params,
    bias: Optional[torch.Tensor],
    *,
    n_modes: Sequence[int],
    max_n_modes: Sequence[int],
    complex_data: bool = False,
    separable: bool = False,
    implementation: str = "reconstructed",
    fft_norm: str = "forward",
    fno_block_precision: str = "full",
    enforce_hermitian_symmetry: bool = True,
    resolution_scaling_factor: Optional[Sequence[float]] = None,
    output_shape: Optional[Sequence[int]] = None,
    model_group=None,
) -> torch.Tensor:
    """Functional core: x (b, in, d1..dN), the weight's ``spec`` and its
    factors ``params`` (``{name: (re, im)}``).

    With ``model_group``, ``params`` hold this rank's out channels of a
    dense weight: the contraction's input enters the model-parallel region
    (its gradient all-reduced over the group) and its output is
    all-gathered along the channels before the inverse transforms.

    ``n_modes`` has the last dim already halved on real data
    (``halve_last_mode``); ``resolution_scaling_factor`` is one factor per
    dim (``validate_scaling_factor``), overridden by ``output_shape``.
    """
    order = len(n_modes)
    mode_sizes = list(x.shape[2:])
    if len(mode_sizes) != order:
        raise ValueError(
            f"input has {len(mode_sizes)} spatial dims but n_modes has {order}"
        )
    mixed = fno_block_precision in ("half", "mixed")
    if fno_block_precision == "half":
        # JAX's cast through bfloat16 keeps the real part of complex x
        x = (x.real if x.is_complex() else x).to(torch.bfloat16)

    fft_size = list(mode_sizes)
    if not complex_data:
        fft_size[-1] = fft_size[-1] // 2 + 1
    axes = list(range(-order, 0))

    # active modes sit at the centre of the stored weight (start of the
    # last dim on real data); the slices index its (in, out, modes...) dims
    slices = resolve_weight_slices(
        fft_size, n_modes, max_n_modes, separable=separable, complex_data=complex_data
    )
    spec, params = slice_factors(spec, params, slices)
    kept = list(spec.shape[1 if separable else 2:])

    if complex_data:
        xf = torch.fft.fftn(x if x.is_complex() else x.float(), norm=fft_norm, dim=axes)
        spectrum = torch.stack([xf.real, xf.imag])
        if mixed:
            spectrum = spectrum.to(torch.bfloat16).float()
        block = gather_center_modes(spectrum, kept, axes)
        br, bi = block[0], block[1]
    else:
        kept_last = min(kept[-1], fft_size[-1])
        if mode_sizes[-1] <= MAX_DFT_AXIS:
            # the DFT matmuls run on bfloat16 x under "half" and "mixed"
            br, bi = rdft_gather_last(x.to(torch.bfloat16 if mixed else torch.float32),
                                      kept_last, fft_norm)
        else:
            xf = torch.fft.rfft(x.float(), dim=-1, norm=fft_norm)[..., :kept_last]
            br, bi = xf.real, xf.imag
            if mixed:
                br, bi = br.to(torch.bfloat16), bi.to(torch.bfloat16)
        for i, ax in enumerate(axes[:-1]):
            br, bi = dft_gather_axis(br, bi, min(kept[i], mode_sizes[i]), ax, fft_norm)
        if kept_last < kept[-1]:
            # weight wider than the spectrum: trim its last-mode factor
            trim = [slice(None)] * spec.order
            trim[-1] = slice(0, kept_last)
            spec, params = slice_factors(spec, params, trim)

    if model_group is not None:
        br = copy_to_model_parallel_region(br, model_group)
        bi = copy_to_model_parallel_region(bi, model_group)
    out_r, out_i = contract_block((br, bi), spec, params, separable=separable,
                                  implementation=implementation,
                                  compute_dtype=torch.bfloat16 if mixed else None)
    if model_group is not None:
        out_r = gather_from_model_parallel_region(out_r, 1, model_group)
        out_i = gather_from_model_parallel_region(out_i, 1, model_group)

    out_sizes = list(mode_sizes)
    if resolution_scaling_factor is not None and output_shape is None:
        out_sizes = [round(s * r) for s, r in zip(mode_sizes, resolution_scaling_factor)]
    if output_shape is not None:
        out_sizes = list(output_shape)

    if complex_data:
        # the block is (b, o, modes...): its mode axes are the stack's too
        block = _shrink_centered(torch.stack([out_r, out_i]), out_sizes, axes)
        full = scatter_center_modes(block, out_sizes, axes)
        y = torch.fft.ifftn(torch.complex(full[0], full[1]), dim=axes, norm=fft_norm)
    else:
        half = out_sizes[-1] // 2 + 1
        out_r = _shrink_centered(out_r, out_sizes[:-1], axes[:-1])
        out_i = _shrink_centered(out_i, out_sizes[:-1], axes[:-1])
        out_r = out_r[..., : min(out_r.shape[-1], half)]
        out_i = out_i[..., : min(out_i.shape[-1], half)]
        if mixed:
            out_r, out_i = out_r.to(torch.bfloat16), out_i.to(torch.bfloat16)
        for i, ax in enumerate(axes[:-1]):
            out_r, out_i = dft_scatter_axis(out_r, out_i, out_sizes[i], ax, fft_norm)
        if out_sizes[-1] <= MAX_DFT_AXIS and enforce_hermitian_symmetry:
            y = rdft_scatter_last(out_r, out_i, out_sizes[-1], fft_norm)
        else:
            # the earlier axes are inverted already: the last one remains
            y = irfft_hermitian(torch.complex(out_r.float(), out_i.float()), out_sizes[-1:],
                                [-1], fft_norm, enforce_hermitian_symmetry)
    if mixed:
        y = (y.real if y.is_complex() else y).to(torch.bfloat16)
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
