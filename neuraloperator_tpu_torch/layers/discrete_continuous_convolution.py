"""DISCO: discrete-continuous convolutions (port of
``neuraloperator_tpu/layers/discrete_continuous_convolution.py``).

A local integral operator whose kernel is a learned combination of fixed
filter-basis functions, discretized on the grid. The basis (piecewise-linear
hats on the disk of the cutoff radius, Morlet or Zernike) is the JAX
package's numpy code, copied, so the stencils are equal to the bit. On an
equidistant grid the kernel is ``einsum("oik,kxy->oixy", weight, psi)``
followed by one grouped ``conv2d`` (cuDNN, at ``training.setup``'s
precision: ``ops/convolution.py``) after a wrap or zero pad; the transpose
convolution dilates its input by the stride and convolves, as
``lax.conv_transpose`` does. Between arbitrary point sets the
host-precomputed filter matrix ``psi`` (K, n_out, n_in) is passed at call
time and applied as a matmul, then a grouped channel mix. Parameters keep
the JAX names, ``weight`` and ``bias``.
"""

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.convolution import conv_nd
from . import _init


def _hat(x: np.ndarray, center: float, width: float) -> np.ndarray:
    return np.clip(1.0 - np.abs(x - center) / width, 0.0, None)


def _periodic_hat(phi: np.ndarray, center: float, width: float) -> np.ndarray:
    d = np.abs(np.angle(np.exp(1j * (phi - center))))
    return np.clip(1.0 - d / width, 0.0, None)


def num_basis_functions(kernel_shape: Sequence[int], basis_type: str = "piecewise_linear") -> int:
    if basis_type == "zernike":
        n = kernel_shape[0]
        return (n + 1) * (n + 2) // 2
    if basis_type == "morlet":
        nr = kernel_shape[0]
        nphi = kernel_shape[1] if len(kernel_shape) == 2 else 1
        return nr * nphi
    if len(kernel_shape) == 1:
        return kernel_shape[0]
    nr, nphi = kernel_shape
    return 1 + (nr - 1) * nphi


def _morlet(r, phi, k_r, k_phi):
    """Real Morlet-style wavelet on the disk (torch_harmonics 'morlet')."""
    envelope = np.exp(-0.5 * (3.0 * r) ** 2)
    return envelope * np.cos(np.pi * (k_r * r * np.cos(phi) + k_phi * r * np.sin(phi)))


def _zernike(r, phi, n, m):
    """Zernike polynomial Z_n^m on the unit disk."""
    R = np.zeros_like(r)
    mm = abs(m)
    for k in range((n - mm) // 2 + 1):
        c = ((-1) ** k * math.factorial(n - k)) / (
            math.factorial(k)
            * math.factorial((n + mm) // 2 - k)
            * math.factorial((n - mm) // 2 - k)
        )
        R = R + c * r ** (n - 2 * k)
    if m >= 0:
        return R * np.cos(mm * phi)
    return R * np.sin(mm * phi)


def _basis_funcs(r, phi, kernel_shape: Tuple[int, ...], basis_type: str):
    """Every basis function at normalized radius/angle arrays."""
    if basis_type == "morlet":
        nr, nphi = (
            kernel_shape if len(kernel_shape) == 2 else (kernel_shape[0], 1)
        )
        return [
            _morlet(r, phi, k_r, k_phi)
            for k_r in range(nr)
            for k_phi in range(nphi)
        ]
    if basis_type == "zernike":
        n_max = kernel_shape[0]
        return [
            _zernike(np.clip(r, 0, 1), phi, n, m)
            for n in range(n_max + 1)
            for m in range(-n, n + 1, 2)
        ]
    if len(kernel_shape) == 1:
        nr = kernel_shape[0]
        radii = np.linspace(0, 1, nr)
        width = 1.0 / max(nr - 1, 1)
        return [_hat(r, c, width) for c in radii]
    nr, nphi = kernel_shape
    radii = np.linspace(0, 1, nr)
    rwidth = 1.0 / max(nr - 1, 1)
    pwidth = 2 * np.pi / nphi
    funcs = [_hat(r, 0.0, rwidth)]  # center
    for i in range(1, nr):
        for j in range(nphi):
            c_phi = 2 * np.pi * j / nphi - np.pi
            funcs.append(
                _hat(r, radii[i], rwidth) * _periodic_hat(phi, c_phi, pwidth)
            )
    return funcs


@functools.lru_cache(maxsize=64)
def equidistant_filter_basis(
    kernel_shape: Tuple[int, ...], kernel_size: int,
    basis_type: str = "piecewise_linear",
) -> np.ndarray:
    """psi (K, ks, ks): the basis stencils on an odd-size square support,
    each normalized to unit absolute sum over the stencil."""
    ks = kernel_size
    if ks % 2 != 1:
        raise ValueError("kernel_size must be odd")
    half = ks // 2
    xs = np.arange(-half, half + 1) / max(half, 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2)
    phi = np.arctan2(Y, X)
    psi = np.stack(_basis_funcs(r, phi, tuple(kernel_shape), basis_type))
    psi = np.where(r[None] <= 1.0, psi, 0.0)
    norms = np.abs(psi).sum(axis=(1, 2), keepdims=True)
    psi = psi / np.maximum(norms, 1e-12)
    return psi.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _basis_tensor(kernel_shape: Tuple[int, ...], kernel_size: int, basis_type: str,
                  device: torch.device) -> torch.Tensor:
    """The stencils on ``device``, built once and outside inference mode (as
    the DFT matrices are)."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            equidistant_filter_basis(kernel_shape, kernel_size, basis_type)).to(device)


def _disco_weight(out_channels: int, in_channels: int, groups: int, K: int, device,
                  generator) -> nn.Parameter:
    """``sqrt(2 / (in_channels K)) N(0, 1)`` of shape (out, in / groups, K)."""
    return _init.normal((out_channels, in_channels // groups, K),
                        math.sqrt(2.0 / (in_channels * K)), device, generator)


class EquidistantDiscreteContinuousConv2d(nn.Module):
    """DISCO convolution on an equidistant 2-D grid, "same" output size.

    ``weight`` is (out, in / groups, K); ``bias`` (out,), zeros, when
    ``use_bias``. ``padding_mode`` is "periodic" (wrap) or anything else
    (zeros), as in the JAX module.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_shape: Tuple[int, ...] = (2,), kernel_size: int = 3, groups: int = 1,
                 use_bias: bool = True, padding_mode: str = "zeros",
                 basis_type: str = "piecewise_linear", *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_shape, self.kernel_size = tuple(kernel_shape), kernel_size
        self.groups, self.padding_mode, self.basis_type = groups, padding_mode, basis_type
        K = num_basis_functions(self.kernel_shape, basis_type)
        self.weight = _disco_weight(out_channels, in_channels, groups, K, device, generator)
        self.bias = _init.constant((out_channels,), 0.0, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        psi = _basis_tensor(self.kernel_shape, self.kernel_size, self.basis_type,
                            self.weight.device)
        kernel = torch.einsum("oik,kxy->oixy", self.weight, psi)
        pad = self.kernel_size // 2
        mode = "circular" if self.padding_mode == "periodic" else "constant"
        y = conv_nd(nn.functional.pad(x, [pad] * 4, mode=mode), kernel, self.groups)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


def _conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s "SAME" padding of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class EquidistantDiscreteContinuousConvTranspose2d(nn.Module):
    """Transpose DISCO convolution for upsampling by ``stride``.

    ``weight`` is (in / groups, out, K), as the JAX module declares it. The
    output is ``lax.conv_transpose(x, kernel, strides, "SAME",
    ("NCHW", "IOHW", "NCHW"))``: the input dilated by the stride, padded,
    and cross-correlated with the kernel unflipped. ``lax.conv_transpose``
    has no feature groups, so ``groups`` other than 1 raises there and here.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_shape: Tuple[int, ...] = (2,), kernel_size: int = 3, stride: int = 2,
                 groups: int = 1, use_bias: bool = True, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if groups != 1:
            raise ValueError("EquidistantDiscreteContinuousConvTranspose2d supports groups=1 "
                             "only, as lax.conv_transpose does")
        self.kernel_shape, self.kernel_size, self.stride = (
            tuple(kernel_shape), kernel_size, stride)
        K = num_basis_functions(self.kernel_shape)
        self.weight = _init.normal((in_channels // groups, out_channels, K),
                                   math.sqrt(2.0 / (in_channels * K)), device, generator)
        self.bias = _init.constant((out_channels,), 0.0, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        psi = _basis_tensor(self.kernel_shape, self.kernel_size, "piecewise_linear",
                            self.weight.device)
        kernel = torch.einsum("iok,kxy->oixy", self.weight, psi)
        s = self.stride
        b, c, h, w = x.shape
        dilated = x.new_zeros((b, c, (h - 1) * s + 1, (w - 1) * s + 1))
        dilated[:, :, ::s, ::s] = x
        lo, hi = _conv_transpose_padding(self.kernel_size, s)
        y = conv_nd(nn.functional.pad(dilated, [lo, hi, lo, hi]), kernel)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


def _grouped_channel_mix(z: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """z (b, in, K, m), w (out, in / groups, K) -> (b, out, m): the grouped
    einsum ``"bgckm,gock->bgom"``."""
    b, c_in, K, m = z.shape
    o = w.shape[0]
    if groups == 1:
        return torch.einsum("bikm,oik->bom", z, w)
    zg = z.reshape(b, groups, c_in // groups, K, m)
    wg = w.reshape(groups, o // groups, w.shape[1], K)
    return torch.einsum("bgckm,gock->bgom", zg, wg).reshape(b, o, m)


class DiscreteContinuousConv2d(nn.Module):
    """DISCO convolution between arbitrary point sets: ``forward(x, psi)``
    with x (b, in, n_in) and the filter matrix psi (K, n_out, n_in) from
    :func:`precompute_filter_matrix`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_shape: Tuple[int, ...] = (2,), groups: int = 1, use_bias: bool = True,
                 basis_type: str = "piecewise_linear", *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.groups = groups
        K = num_basis_functions(tuple(kernel_shape), basis_type)
        self.weight = _disco_weight(out_channels, in_channels, groups, K, device, generator)
        self.bias = _init.constant((out_channels,), 0.0, device) if use_bias else None

    def forward(self, x: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        # integrate the basis against the input: (b, c, K, n_out)
        z = torch.einsum("bcn,kmn->bckm", x, psi)
        y = _grouped_channel_mix(z, self.weight, self.groups)
        if self.bias is not None:
            y = y + self.bias[None, :, None]
        return y


class DiscreteContinuousConvTranspose2d(DiscreteContinuousConv2d):
    """Transpose DISCO convolution between arbitrary point sets: the same
    computation as :class:`DiscreteContinuousConv2d`, with the transposed
    filter matrix (``precompute_filter_matrix(..., transpose=True)``)."""


def precompute_filter_matrix(
    in_coords: np.ndarray,
    out_coords: np.ndarray,
    kernel_shape: Sequence[int],
    radius_cutoff: float,
    quadrature_weights: Optional[np.ndarray] = None,
    basis_type: str = "piecewise_linear",
    periodic: bool = False,
    transpose: bool = False,
    normalize: bool = True,
) -> np.ndarray:
    """psi (K, n_out, n_in) for DISCO between point sets, on the host: each
    basis function at the offsets between output and input points (reversed
    when ``transpose``; wrapped to the nearest image on the unit torus when
    ``periodic``), cut at ``radius_cutoff``, times the input quadrature
    weights, and, when ``normalize``, divided per (basis, output point) by
    its signed sum (+1e-9) for the piecewise-linear basis and by its
    absolute sum (at least 1e-9) for the others."""
    n_in = len(in_coords)
    if quadrature_weights is None:
        quadrature_weights = np.full(n_in, 1.0 / n_in)
    diff = out_coords[:, None, :] - in_coords[None, :, :]
    if transpose:
        diff = -diff
    if periodic:
        alt = np.where(diff > 0.0, diff - 1.0, diff + 1.0)
        diff = np.where(np.abs(diff) < np.abs(alt), diff, alt)
    r = np.linalg.norm(diff, axis=-1) / radius_cutoff
    phi = np.arctan2(diff[..., 1], diff[..., 0])

    psi = np.stack(_basis_funcs(r, phi, tuple(kernel_shape), basis_type))
    psi = np.where(r[None] <= 1.0, psi, 0.0)
    psi = psi * quadrature_weights[None, None, :]
    if normalize:
        if basis_type == "piecewise_linear":
            norms = psi.sum(axis=2, keepdims=True)
            psi = psi / (norms + 1e-9)
        else:
            norms = np.abs(psi).sum(axis=2, keepdims=True)
            psi = psi / np.maximum(norms, 1e-9)
    return psi.astype(np.float32)
