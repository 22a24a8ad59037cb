"""Fourier-domain mode truncation as truncated DFT matmuls.

Port of ``neuraloperator_tpu/ops/fourier.py`` (the truncated-DFT path).
Only ``kept << n`` frequencies survive a spectral convolution, so each
axis transform is one ``(kept x n)`` DFT matmul and each inverse one
``(n_out x kept)`` matmul whose structure enforces the DC/Nyquist
Hermitian constraint. These are plain large matmuls, left to
``torch.matmul`` as the JAX package left them to XLA.

The matrices are built once per (n, kept, norm) in numpy (float64 maths,
stored as float32) and cached as tensors once per device, outside inference
mode so that serving and training can share them in one process.
"""

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

_FORWARD_SCALE = {"forward": lambda n: 1.0 / n, "backward": lambda n: 1.0,
                  "ortho": lambda n: n ** -0.5}
_INVERSE_SCALE = {"forward": lambda n: 1.0, "backward": lambda n: 1.0 / n,
                  "ortho": lambda n: n ** -0.5}


def kept_mode_counts(kept: int, size: int) -> Tuple[int, int]:
    """Split ``kept`` centered modes into (negative, nonneg) frequency counts.

    After fftshift the 0-frequency sits at ``size // 2`` and the kept block
    is ``[center - kept//2, center + kept//2 + kept%2)``; in natural FFT
    order that is the last ``kept//2`` entries (negative frequencies) and
    the first ``kept//2 + kept%2`` (0 and positive).
    """
    kept = min(kept, size)
    neg = kept // 2
    pos = kept // 2 + kept % 2
    return neg, pos


@functools.lru_cache(maxsize=256)
def _dft_gather_np(n: int, kept: int, norm: str) -> np.ndarray:
    """(2, kept, n) real/imag centered-mode DFT matrix.

    Row k holds frequency f_k in the centered order [-neg..-1, 0..pos-1]:
    D[k, h] = scale * exp(-2i pi f_k h / n).
    """
    neg, pos = kept_mode_counts(kept, n)
    freqs = np.concatenate([np.arange(-neg, 0), np.arange(0, pos)])
    h = np.arange(n)
    d = np.exp(-2j * np.pi * freqs[:, None] * h[None, :] / n)
    d = d * _FORWARD_SCALE[norm](n)
    return np.stack([d.real, d.imag]).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _dft_scatter_np(n_out: int, kept: int, norm: str) -> np.ndarray:
    """(2, n_out, kept) inverse-DFT matrix embedding centered modes.

    Column k holds frequency k - neg (the centered order); equals the ifft
    of the block scattered into a zero spectrum of size ``n_out``.
    """
    neg = kept // 2
    pos = kept - neg
    freqs = np.concatenate([np.arange(-neg, 0), np.arange(0, pos)])
    h = np.arange(n_out)
    d = np.exp(2j * np.pi * h[:, None] * freqs[None, :] / n_out)
    d = d * _INVERSE_SCALE[norm](n_out)
    return np.stack([d.real, d.imag]).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _rdft_gather_np(n: int, kept: int, norm: str) -> np.ndarray:
    """(2, kept, n): real-input DFT onto the lowest ``kept`` rfft bins."""
    k = np.arange(kept)
    w = np.arange(n)
    ang = 2 * np.pi * k[:, None] * w[None, :] / n
    scale = _FORWARD_SCALE[norm](n)
    return np.stack(
        [np.cos(ang) * scale, -np.sin(ang) * scale]
    ).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _rdft_scatter_np(n_out: int, kept: int, norm: str) -> np.ndarray:
    """(2, n_out, kept): truncated inverse rfft as two real matmuls.

    ``y = A[0] @ cr + A[1] @ ci`` equals ``irfft(pad(c), n_out)`` for a
    half-spectrum whose DC (and Nyquist) imaginary parts are zero: bins
    other than DC/Nyquist are conjugate-doubled, and the imaginary columns
    of DC/Nyquist are zeroed, which enforces Hermitian symmetry.
    """
    k = np.arange(kept)
    w = np.arange(n_out)
    ang = 2 * np.pi * w[:, None] * k[None, :] / n_out
    weight = np.where(
        (k == 0) | ((n_out % 2 == 0) & (k == n_out // 2)), 1.0, 2.0
    )
    scale = _INVERSE_SCALE[norm](n_out)
    a_r = np.cos(ang) * weight[None, :] * scale
    a_i = -np.sin(ang) * weight[None, :] * scale
    a_i[:, 0] = 0.0
    if n_out % 2 == 0 and kept - 1 == n_out // 2:
        a_i[:, kept - 1] = 0.0
    return np.stack([a_r, a_i]).astype(np.float32)


_BUILDERS = {
    "dft_gather": _dft_gather_np,
    "dft_scatter": _dft_scatter_np,
    "rdft_gather": _rdft_gather_np,
    "rdft_scatter": _rdft_scatter_np,
}


@functools.lru_cache(maxsize=256)
def _matrix(kind: str, n: int, kept: int, norm: str,
            device: torch.device) -> torch.Tensor:
    """One cached (2, rows, cols) float32 matrix on ``device``.

    Built outside inference mode whatever mode the caller is in: a matrix
    first built by a served forward (``torch.inference_mode``) would
    otherwise be an inference tensor, which a later training forward at the
    same sizes cannot save for its backward.
    """
    with torch.inference_mode(False):
        return torch.from_numpy(_BUILDERS[kind](n, kept, norm)).to(device)


def _axis_complex_matmul(xr, xi, d: torch.Tensor, axis: int):
    """Apply a complex (rows x n) matrix along ``axis`` of split-real x."""
    axis = axis % xr.ndim
    dr, di = d[0].to(xr.dtype), d[1].to(xr.dtype)
    ar, ai = xr.movedim(axis, -2), xi.movedim(axis, -2)
    yr = torch.matmul(dr, ar) - torch.matmul(di, ai)
    yi = torch.matmul(dr, ai) + torch.matmul(di, ar)
    return yr.movedim(-2, axis), yi.movedim(-2, axis)


def dft_gather_axis(xr, xi, kept: int, axis: int, norm: str):
    """fft + centered gather along one axis as a truncated DFT matmul."""
    n = xr.shape[axis]
    d = _matrix("dft_gather", n, kept, norm, xr.device)
    return _axis_complex_matmul(xr, xi, d, axis)


def dft_scatter_axis(xr, xi, n_out: int, axis: int, norm: str):
    """centered scatter + ifft along one axis as an inverse-DFT matmul."""
    kept = xr.shape[axis]
    d = _matrix("dft_scatter", n_out, kept, norm, xr.device)
    return _axis_complex_matmul(xr, xi, d, axis)


def rdft_gather_last(x: torch.Tensor, kept: int, norm: str):
    """``rfft(x, dim=-1)[..., :kept]`` as two real matmuls."""
    d = _matrix("rdft_gather", x.shape[-1], kept, norm, x.device).to(x.dtype)
    return torch.matmul(x, d[0].T), torch.matmul(x, d[1].T)


def rdft_scatter_last(cr, ci, n_out: int, norm: str):
    """Hermitian-enforced truncated inverse rfft along the last axis."""
    a = _matrix("rdft_scatter", n_out, cr.shape[-1], norm, cr.device)
    a = a.to(cr.dtype)
    return torch.matmul(cr, a[0].T) + torch.matmul(ci, a[1].T)


def resolve_weight_slices(
    fft_size: Sequence[int],
    n_modes: Sequence[int],
    max_n_modes: Sequence[int],
    separable: bool,
    complex_data: bool,
) -> Tuple[slice, ...]:
    """Slices selecting the active centered modes of the full weight tensor.

    When ``n_modes < max_n_modes`` the kept modes sit at the *center* of
    the weight along each shifted dim and at the *start* along the rfft'd
    last dim. The slices index the weight's ``(in, out, modes...)`` dims
    (``(in, modes...)`` when separable).
    """
    starts = [
        max_m - min(size, n_mode)
        for (size, n_mode, max_m) in zip(fft_size, n_modes, max_n_modes)
    ]
    slices_w: List[slice] = [slice(None)] if separable else [slice(None)] * 2
    if complex_data:
        slices_w += [_center_slice(start) for start in starts]
    else:
        slices_w += [_center_slice(start) for start in starts[:-1]]
        slices_w += [slice(None, -starts[-1]) if starts[-1] else slice(None)]
    return tuple(slices_w)


def _center_slice(start: int) -> slice:
    """``slice(start//2, -start//2)`` with Python floor division.

    For odd ``start`` the extra removed entry comes off the *end*
    (start=3 -> slice(1, -2)).
    """
    if not start:
        return slice(None)
    return slice(start // 2, -start // 2)
