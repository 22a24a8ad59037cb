"""Spherical convolution, the SFNO's layer (port of
``neuraloperator_tpu/layers/spherical_convolution.py``).

SHT -> a per-degree ("dhconv", Driscoll-Healy) complex channel contraction
-> inverse SHT at the output's resolution and grid, plus a bias. The SHT is
``ops/sht.py``; the contraction is a ``complex_einsum`` against the dense
weight or, with ``implementation="factorized"``, directly against its CP,
Tucker or TT factors. None of it reaches the mode-contraction kernels: the
JAX layer's contractions are XLA einsums too.

The weight is indexed by degree only: ``(in, out, n_modes[0])``, or
``(in, n_modes[0])`` separable, sliced to the call's ``lmax``. Parameters
keep the JAX names and storage: ``w_weight`` (or ``w_core``/``w_lambdas``
and ``w_factor_i``) with the real and imaginary parts stacked on a leading
axis of 2, float32, and ``bias`` of shape ``(out, 1, 1)``.
"""

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .._common import resolve_device
from ..ops.complex_einsum import Operand, Parts, complex_einsum
from ..ops.sht import isht, sht
from ..tensor.factorized import (
    FactorizationSpec,
    init_factors,
    resolve_spec,
    slice_factors,
    to_tensor,
)
from ..utils import validate_scaling_factor
from . import _init


def contract_dhconv(x: Operand, weight: Parts, separable: bool = False) -> Parts:
    """x (b, i, l, m) against a weight (i, o, l), or (i, l) separable."""
    if separable:
        return complex_einsum("bilm,il->bilm", x, weight)
    return complex_einsum("bilm,iol->bolm", x, weight)


def contract_dhconv_factorized(x: Operand, spec: FactorizationSpec, params,
                               separable: bool = False) -> Parts:
    """The dhconv contraction against CP, Tucker or TT factors, the weight
    never rebuilt; the degree l is the weight's mode index, shared by every
    order m."""
    factors = [params[f"factor_{i}"] for i in range(spec.order)]
    if spec.kind == "cp":
        eq = "bilm,r,ir,lr->bilm" if separable else "bilm,r,ir,or,lr->bolm"
        return complex_einsum(eq, x, params["lambdas"], *factors)
    if spec.kind == "tucker":
        eq = "bilm,pq,ip,lq->bilm" if separable else "bilm,pqs,ip,oq,ls->bolm"
        return complex_einsum(eq, x, params["core"], *factors)
    if spec.kind == "tt":
        # rank symbols that do not collide with the batch symbol 'b'
        eq = "bilm,xiy,ylz->bilm" if separable else "bilm,xiy,yoz,zlw->bolm"
        return complex_einsum(eq, x, *factors)
    return contract_dhconv(x, to_tensor(spec, params), separable=separable)


class SphericalConv(nn.Module):
    """Spherical convolution on (b, in, nlat, nlon).

    ``n_modes`` = (lmax, m): the weight has ``n_modes[0]`` degrees and the
    SHT keeps ``max(n_modes[1] // 2, 1)`` orders. ``sht_grids`` is one grid
    for input and output or an (input, output) pair. ``max_n_modes``,
    ``fno_block_precision``, ``complex_data`` and
    ``enforce_hermitian_symmetry`` are taken and unused, as in the JAX layer.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_modes: Sequence[int],
        max_n_modes: Optional[Sequence[int]] = None,
        use_bias: bool = True,
        separable: bool = False,
        resolution_scaling_factor=None,
        fno_block_precision: str = "full",
        rank: Union[float, Tuple[int, ...]] = 0.5,
        factorization: Optional[str] = "cp",
        implementation: str = "reconstructed",
        fixed_rank_modes: bool = False,
        init_std: Union[str, float] = "auto",
        sht_norm: str = "ortho",
        sht_grids: Union[str, Sequence[str]] = "equiangular",
        complex_data: bool = False,
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del max_n_modes, fno_block_precision, complex_data, enforce_hermitian_symmetry
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_modes = tuple(int(m) for m in n_modes)
        self.separable = separable
        self.implementation = implementation
        self.sht_norm = sht_norm
        self.grids = ((sht_grids, sht_grids) if isinstance(sht_grids, str)
                      else (sht_grids[0], sht_grids[1]))
        self.resolution_scaling_factor = validate_scaling_factor(
            resolution_scaling_factor, len(self.n_modes))
        if separable:
            if in_channels != out_channels:
                raise ValueError("separable SphericalConv requires in_channels == out_channels")
            weight_shape = (in_channels, *self.n_modes[:-1])
        else:
            weight_shape = (in_channels, out_channels, *self.n_modes[:-1])
        self.spec = resolve_spec(factorization, weight_shape, rank,
                                 [0] if fixed_rank_modes is True else None)
        std = ((2 / (in_channels + out_channels)) ** 0.5 if init_std == "auto"
               else float(init_std))
        device = resolve_device(device)
        self.factor_names = []
        for name, param in init_factors(self.spec, std, device, generator).items():
            self.register_parameter(f"w_{name}", param)
            self.factor_names.append(name)
        self.bias = (_init.normal((out_channels, 1, 1), std, device, generator)
                     if use_bias else None)

    def factors(self):
        """``{name: (re, im)}`` of the stored factors."""
        out = {}
        for name in self.factor_names:
            w = getattr(self, f"w_{name}")
            out[name] = (w[0], w[1])
        return out

    def _output_size(self, in_size, output_shape) -> Tuple[int, int]:
        rsf = self.resolution_scaling_factor
        if output_shape is not None:
            return tuple(output_shape)
        if rsf is not None:
            return round(in_size[0] * rsf[0]), round(in_size[1] * rsf[1])
        return tuple(in_size)

    def forward(self, x: torch.Tensor, output_shape: Optional[Sequence[int]] = None,
                n_modes: Optional[Sequence[int]] = None) -> torch.Tensor:
        modes = list(self.n_modes if n_modes is None else n_modes)
        height, width = self._output_size(x.shape[-2:], output_shape)
        grid_in, grid_out = self.grids
        lmax, mmax = modes[0], max(modes[1] // 2, 1)
        flm = sht(x, lmax=lmax, mmax=mmax, grid=grid_in, norm=self.sht_norm)
        # the weight's leading degrees, as many as the call keeps
        slices = [slice(None)] * (1 if self.separable else 2) + [slice(0, lmax)]
        spec, params = slice_factors(self.spec, self.factors(), slices)
        if self.implementation == "factorized" and spec.kind != "dense":
            out = contract_dhconv_factorized(flm, spec, params, separable=self.separable)
        else:
            out = contract_dhconv(flm, to_tensor(spec, params), separable=self.separable)
        y = isht(out, nlat=height, nlon=width, grid=grid_out, norm=self.sht_norm)
        if self.bias is not None:
            y = y + self.bias[None]
        return y

    def transform(self, x: torch.Tensor,
                  output_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Resample a skip branch to this layer's output resolution and grid
        through the SHT; the identity when neither changes."""
        in_size = tuple(x.shape[-2:])
        height, width = self._output_size(in_size, output_shape)
        grid_in, grid_out = self.grids
        if in_size == (height, width) and grid_in == grid_out:
            return x
        flm = sht(x, lmax=self.n_modes[0], mmax=max(self.n_modes[1] // 2, 1), grid=grid_in,
                  norm=self.sht_norm)
        return isht(flm, nlat=height, nlon=width, grid=grid_out, norm=self.sht_norm)


__all__ = ["SphericalConv", "contract_dhconv", "contract_dhconv_factorized"]
