"""Resolution resampling of gridded functions (port of
``neuraloperator_tpu/layers/resample.py``).

Linear interpolation for one spatial dim, bicubic for two (both with
``align_corners=True`` sampling), spectral (Fourier) resampling for three
or more. Interpolation along an axis is a fixed linear map: the JAX
package's numpy matrix, copied here, applied as a matmul (not
``F.interpolate``, whose bicubic samples the border differently).
"""

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _interp_matrix(n_in: int, n_out: int, kind: str) -> np.ndarray:
    """(n_out, n_in) interpolation matrix with align_corners=True sampling."""
    if n_out == 1 or n_in == 1:
        src = np.zeros(n_out)
    else:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    W = np.zeros((n_out, n_in), dtype=np.float32)
    if kind == "linear":
        i0 = np.clip(np.floor(src).astype(int), 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        t = src - np.floor(src)
        for row in range(n_out):
            W[row, i0[row]] += 1.0 - t[row]
            W[row, i1[row]] += t[row]
        return W
    if kind == "cubic":
        # Keys cubic convolution kernel, a = -0.75 (torch's bicubic)
        a = -0.75

        def k(x):
            x = abs(x)
            if x <= 1:
                return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
            if x < 2:
                return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
            return 0.0

        for row in range(n_out):
            base = int(np.floor(src[row]))
            for tap in range(-1, 3):
                idx = base + tap
                w = k(src[row] - idx)
                W[row, int(np.clip(idx, 0, n_in - 1))] += w
        return W
    raise ValueError(f"unknown interpolation kind {kind}")


@functools.lru_cache(maxsize=128)
def _interp_tensor(n_in: int, n_out: int, kind: str, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The transposed matrix on ``device``, built once and outside inference
    mode (as the DFT matrices are)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(n_in, n_out, kind).T.copy()).to(device, dtype)


def _apply_axis_matrix(x: torch.Tensor, n_in: int, n_out: int, kind: str,
                       axis: int) -> torch.Tensor:
    """The (n_out, n_in) matrix applied along ``axis``; ``n_in`` is the size
    ``resample`` read from the trailing axes, as in the JAX function, so an
    axis of another size raises there as it does in JAX."""
    xm = x.movedim(axis, -1)
    y = torch.matmul(xm, _interp_tensor(n_in, n_out, kind, x.device, x.dtype))
    return y.movedim(-1, axis)


def resample(
    x: torch.Tensor,
    res_scale: Union[float, Sequence[float]],
    axis: Union[int, Sequence[int], None],
    output_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Resample ``x`` (batch, channels, d1..dN) along ``axis``: linear for
    one axis, bicubic for two, spectral for three or more."""
    if isinstance(res_scale, (float, int)):
        if axis is None:
            axis = list(range(2, x.ndim))
            res_scale = [res_scale] * len(axis)
        elif isinstance(axis, int):
            axis = [axis]
            res_scale = [res_scale]
        else:
            axis = list(axis)
            res_scale = [res_scale] * len(axis)
    else:
        axis = list(axis)
        if len(res_scale) != len(axis):
            raise ValueError("res_scale and axis length mismatch")

    old_size = tuple(x.shape[-len(axis):])
    if output_shape is None:
        new_size = tuple(int(round(s * r)) for s, r in zip(old_size, res_scale))
    else:
        new_size = tuple(output_shape)
    if old_size == new_size:
        return x
    if len(axis) == 1:
        return _apply_axis_matrix(x, old_size[0], new_size[0], "linear", axis[0])
    if len(axis) == 2:
        y = _apply_axis_matrix(x, old_size[0], new_size[0], "cubic", axis[0])
        return _apply_axis_matrix(y, old_size[1], new_size[1], "cubic", axis[1])
    return spectral_resample(x, new_size, axis)


def spectral_resample(x: torch.Tensor, new_size: Sequence[int],
                      axes: Sequence[int]) -> torch.Tensor:
    """Fourier-domain resampling: the low modes copied into the target
    spectrum (corner copy, "forward" norm), in float32, returned in x's dtype."""
    axes = list(axes)
    in_dtype = x.dtype
    X = torch.fft.rfftn(x.float(), norm="forward", dim=axes)
    new_fft = list(new_size)
    new_fft[-1] = new_fft[-1] // 2 + 1
    keep = [min(n, o) for n, o in zip(new_fft, X.shape[-len(axes):])]
    # earlier axes: keep the first and last m//2 rows, zeros between
    for ax, m, target in zip(axes[:-1], keep[:-1], new_fft[:-1]):
        half = m // 2
        parts = [X.narrow(ax, 0, half)]
        mid = list(X.shape)
        mid[ax] = target - 2 * half
        if mid[ax] > 0:
            parts.append(X.new_zeros(mid))
        if half > 0:
            parts.append(X.narrow(ax, X.shape[ax] - half, half))
        X = torch.cat(parts, dim=ax)
    # last axis: the low rfft modes
    ax = axes[-1] % X.ndim
    X = X.narrow(ax, 0, keep[-1])
    if X.shape[ax] < new_fft[-1]:
        X = torch.nn.functional.pad(X, [0, 0] * (X.ndim - 1 - ax)
                                    + [0, new_fft[-1] - X.shape[ax]])
    y = torch.fft.irfftn(X, s=list(new_size), norm="forward", dim=axes)
    return y.to(in_dtype)


def iterative_resample(x: torch.Tensor, res_scale, axis) -> torch.Tensor:
    """Per-axis sequential resampling."""
    if isinstance(axis, list) and isinstance(res_scale, (float, int)):
        res_scale = [res_scale] * len(axis)
    if isinstance(axis, list):
        for rs, a in zip(res_scale, axis):
            x = resample(x, rs, a)
        return x
    return resample(x, res_scale, axis)
