"""Legacy (v1) spectral convolutions (port of
``neuraloperator_tpu/layers/legacy_spectral_convolution.py``).

Corner (not fftshifted) modes of ``torch.fft.rfftn``, contracted by the
split-real ``ops.complex_einsum`` (not the mode-contraction kernels, as in
the JAX package), in ``SpectralConv1d/2d/3d`` and in
``JointFactorizedSpectralConv``: one factorized tensor for the weights of
every layer, each layer's view a ``SubConv``. The parameters keep the flax
names and layouts: ``weight`` ``(2, [blocks,] in, out, *modes)``, the real
and imaginary parts first; ``w_{factor}`` ``(2, ...)`` and ``bias``
``(n_layers, out, 1, ..)``. The spectra are inverted as pocketfft inverts
them (``ops.fourier.irfftn_pocketfft``): the corner blocks' weights are
independent, so the spectrum is not Hermitian, and cuFFT's inverse would
read it otherwise.
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .._common import resolve_device
from ..ops.complex_einsum import Parts, complex_einsum
from ..ops.fourier import irfftn_pocketfft
from ..tensor.factorized import factor_shapes, init_factors, resolve_spec, to_tensor
from . import _init


def _xavier_std(in_channels: int, out_channels: int) -> float:
    return (2 / (in_channels + out_channels)) ** 0.5


def _spectrum(x: torch.Tensor, order: int) -> Parts:
    xf = torch.fft.rfftn(x.float(), dim=tuple(range(-order, 0)), norm="forward")
    return xf.real, xf.imag


def _cut(parts: Parts, index) -> Parts:
    return parts[0][index], parts[1][index]


def _contract(sub: str, x: Parts, w: Parts) -> Parts:
    return complex_einsum(f"bi{sub},io{sub}->bo{sub}", x, w)


def _fill(blocks: List[Parts], dim: int, size: int) -> Parts:
    """``[low, zeros, high]`` along ``dim``, ``size`` long."""
    low, high = blocks

    def part(k):
        shape = list(low[k].shape)
        shape[dim] = size - low[k].shape[dim] - high[k].shape[dim]
        return torch.cat([low[k], low[k].new_zeros(shape), high[k]], dim=dim)

    return part(0), part(1)


def _invert(spec: Parts, sizes: Sequence[int]) -> torch.Tensor:
    """The spectrum zero-padded along its last axis to ``sizes[-1] // 2 +
    1`` and inverted over ``len(sizes)`` axes."""
    half = sizes[-1] // 2 + 1
    pad = half - spec[0].shape[-1]
    re, im = (nn.functional.pad(p, (0, pad)) for p in spec)
    return irfftn_pocketfft(torch.complex(re, im), list(sizes), norm="forward")


def _forward_1d(x: torch.Tensor, w: Parts, modes: int) -> torch.Tensor:
    xf = _spectrum(x, 1)
    kept = min(modes, xf[0].shape[-1])
    keep = (Ellipsis, slice(0, kept))
    return _invert(_contract("x", _cut(xf, keep), _cut(w, keep)), x.shape[-1:])


def _forward_2d(x: torch.Tensor, w_low: Parts, w_high: Parts, m1: int,
                m2: int) -> torch.Tensor:
    """The low and the high rows of the first ``m2`` columns."""
    xf = _spectrum(x, 2)
    k2 = min(m2, xf[0].shape[-1])
    cols = slice(0, k2)
    top = _contract("xy", _cut(xf, (Ellipsis, slice(0, m1), cols)), _cut(w_low, (Ellipsis, cols)))
    bot = _contract("xy", _cut(xf, (Ellipsis, slice(-m1, None), cols)),
                    _cut(w_high, (Ellipsis, cols)))
    return _invert(_fill([top, bot], -2, x.shape[-2]), x.shape[-2:])


class SpectralConv1d(nn.Module):
    """1-D: the first ``n_modes`` modes of the rFFT."""

    def __init__(self, in_channels: int, out_channels: int, n_modes: int, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_modes = n_modes
        self.weight = _init.normal((2, in_channels, out_channels, n_modes),
                                   _xavier_std(in_channels, out_channels),
                                   resolve_device(device), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _forward_1d(x, (self.weight[0], self.weight[1]), self.n_modes)


class SpectralConv2d(nn.Module):
    """2-D: two corner blocks, the low and the high ``n_modes[0]`` rows of
    the first ``n_modes[1]`` columns, each with its own weight."""

    def __init__(self, in_channels: int, out_channels: int, n_modes: Tuple[int, int], *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_modes = tuple(n_modes)
        self.weight = _init.normal((2, 2, in_channels, out_channels, *self.n_modes),
                                   _xavier_std(in_channels, out_channels),
                                   resolve_device(device), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return _forward_2d(x, (w[0, 0], w[1, 0]), (w[0, 1], w[1, 1]), *self.n_modes)


class SpectralConv3d(nn.Module):
    """3-D: four corner blocks (low and high along each of the first two
    axes) of the first ``n_modes[2]`` modes of the last."""

    def __init__(self, in_channels: int, out_channels: int, n_modes: Tuple[int, int, int], *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_modes = tuple(n_modes)
        self.weight = _init.normal((2, 4, in_channels, out_channels, *self.n_modes),
                                   _xavier_std(in_channels, out_channels),
                                   resolve_device(device), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m1, m2, m3 = self.n_modes
        d1, d2 = x.shape[-3:-1]
        xf = _spectrum(x, 3)
        k3 = min(m3, xf[0].shape[-1])
        low1, high1 = slice(0, m1), slice(-m1, None)
        low2, high2 = slice(0, m2), slice(-m2, None)
        corners = ((low1, low2), (high1, low2), (low1, high2), (high1, high2))
        w = self.weight[..., :k3]
        outs = [_contract("xyz", _cut(xf, (Ellipsis, a, b, slice(0, k3))), (w[0, c], w[1, c]))
                for c, (a, b) in enumerate(corners)]
        left = _fill(outs[0:2], -3, d1)
        right = _fill(outs[2:4], -3, d1)
        return _invert(_fill([left, right], -2, d2), x.shape[-3:])


class JointFactorizedSpectralConv(nn.Module):
    """The weights of ``n_layers`` layers as one factorized tensor
    ``(n_layers * blocks, in, out, *half_modes)`` (blocks = 2^(order-1)
    corner blocks; the last mode count halved for the rFFT), rebuilt whole
    at each call; ``forward(x, layer_index)`` runs one layer's slice, in
    1-D or 2-D as in the JAX module."""

    def __init__(self, in_channels: int, out_channels: int, n_modes: Sequence[int],
                 n_layers: int = 1, factorization: Optional[str] = "tucker", rank=0.5,
                 use_bias: bool = True, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_modes = tuple(n_modes)
        self.order = len(self.n_modes)
        self.half_modes = (*self.n_modes[:-1], self.n_modes[-1] // 2 + 1)
        self.n_blocks = 2 ** (self.order - 1)
        shape = (n_layers * self.n_blocks, in_channels, out_channels, *self.half_modes)
        self.spec = resolve_spec(factorization, shape, rank)
        std = _xavier_std(in_channels, out_channels)
        self._factor_names = list(factor_shapes(self.spec))
        for name, p in init_factors(self.spec, std, device, generator).items():
            setattr(self, f"w_{name}", p)
        self.bias = (_init.normal((n_layers, out_channels) + (1,) * self.order, std, device,
                                  generator) if use_bias else None)

    def forward(self, x: torch.Tensor, layer_index: int = 0) -> torch.Tensor:
        factors = {name: tuple(getattr(self, f"w_{name}")) for name in self._factor_names}
        weight = to_tensor(self.spec, factors)
        first = layer_index * self.n_blocks
        if self.order == 1:
            y = _forward_1d(x, _cut(weight, first), self.half_modes[0])
        elif self.order == 2:
            y = _forward_2d(x, _cut(weight, first), _cut(weight, first + 1), *self.half_modes)
        else:
            raise NotImplementedError("joint factorization supports 1-D and 2-D")
        if self.bias is not None:
            y = y + self.bias[layer_index][None]
        return y


class SubConv:
    """Layer ``indices`` of a ``JointFactorizedSpectralConv``."""

    def __init__(self, main_conv: JointFactorizedSpectralConv, indices: int):
        self.main_conv = main_conv
        self.indices = indices

    def __call__(self, x, **kwargs):
        return self.main_conv(x, layer_index=self.indices, **kwargs)
