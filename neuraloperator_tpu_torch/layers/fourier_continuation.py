"""Fourier continuation: extend non-periodic functions to periodic ones
(port of ``neuraloperator_tpu/layers/fourier_continuation.py``).

Per-axis extension matrices, built on the host in float64 by the JAX
package's numpy (``FCLegendre``: normalized Legendre polynomials fitted to
the boundary points; ``FCGram``: a blend of one-sided polynomial
extrapolants), cast to the input's dtype and applied as matmuls.
"""

from typing import Sequence, Union

import numpy as np
import torch
from numpy.polynomial.legendre import Legendre


def _axes(x: torch.Tensor, dim: Union[int, Sequence[int]]):
    axes = list(range(-dim, 0)) if isinstance(dim, int) else list(dim)
    return [a if a >= 0 else x.dim() + a for a in axes]


class FourierContinuation:
    """Base class: build and apply per-axis extension matrices.

    ``extend(x, dim)`` adds ``n_additional_pts`` points along each chosen
    axis (the last ``dim`` axes, or the listed ones), half on each side, so
    that the result is smoothly periodic; ``restrict`` removes them.
    """

    def __init__(self, d: int = 5, n_additional_pts: int = 50):
        self.d = d
        self.n_additional_pts = n_additional_pts
        self.ext_mat: np.ndarray  # (n_additional_pts, 2d), set by the subclass

    def _axis_matrix(self, axis_size: int) -> np.ndarray:
        """The (extended, original) matrix: the identity in the middle and
        the boundary-fitted continuation rows on both sides."""
        c = self.n_additional_pts // 2
        extended = axis_size + self.n_additional_pts
        M = np.zeros((extended, axis_size))
        M[c : c + axis_size] = np.eye(axis_size)
        B = self.ext_mat  # (n_additional_pts, 2d): [left_vals, right_vals]
        if c > 0:
            M[:c, : self.d] = B[-c:, self.d :]
            M[:c, axis_size - self.d :] = B[-c:, : self.d]
            M[-c:, : self.d] = B[:c, self.d :]
            M[-c:, axis_size - self.d :] = B[:c, : self.d]
        return M

    def extend(self, x: torch.Tensor, dim: Union[int, Sequence[int]]):
        for ax in _axes(x, dim):
            M = torch.from_numpy(self._axis_matrix(x.shape[ax])).to(x.device, x.dtype)
            x = torch.tensordot(M, x.movedim(ax, 0), dims=([1], [0])).movedim(0, ax)
        return x

    __call__ = extend

    def restrict(self, x: torch.Tensor, dim: Union[int, Sequence[int]]):
        c = self.n_additional_pts // 2
        for ax in _axes(x, dim):
            x = x.narrow(ax, c, x.shape[ax] - 2 * c)
        return x


class FCLegendre(FourierContinuation):
    """Legendre-basis continuation."""

    def __init__(self, d: int = 5, n_additional_pts: int = 50, rcond=1e-15):
        super().__init__(d, n_additional_pts)
        self.rcond = rcond
        self.ext_mat = self._compute_extension_matrix()

    def _compute_extension_matrix(self) -> np.ndarray:
        total = 2 * self.d + self.n_additional_pts
        h = 2.0 / (total - 1)
        full_grid = -1.0 + h * np.arange(total)
        fit_grid = np.concatenate([full_grid[: self.d], full_grid[-self.d :]])
        extension_grid = full_grid[self.d : -self.d]
        I = np.eye(2 * self.d)
        polys = [
            np.sqrt((2 * j + 1) / 2) * Legendre(I[j]) for j in range(2 * self.d)
        ]
        X = np.stack([P(fit_grid) for P in polys], axis=1)
        Q = np.stack([P(extension_grid) for P in polys], axis=1)
        return Q @ np.linalg.pinv(X, rcond=self.rcond)


class FCGram(FourierContinuation):
    """FC-Gram continuation (Amlani & Bruno 2016, §3.1), built in the package
    as the JAX package builds it: polynomials of degree < d extrapolate each
    boundary stencil of d points, blended across the continuation region so
    that the extension is periodic. An odd ``n_additional_pts`` loses one.
    """

    def __init__(self, d: int = 5, n_additional_pts: int = 50):
        if n_additional_pts % 2 == 1:
            n_additional_pts -= 1
        super().__init__(d, n_additional_pts)
        self.ext_mat = self._compute_extension_matrix()

    def _compute_extension_matrix(self) -> np.ndarray:
        # same geometric layout as FCLegendre, but with a smooth two-sided
        # blend of one-sided polynomial extrapolants (FC-Gram flavor)
        d, n_add = self.d, self.n_additional_pts
        total = 2 * d + n_add
        grid = np.arange(total, dtype=np.float64)
        left_pts = grid[:d]       # "left" boundary stencil (end of signal)
        right_pts = grid[-d:]     # "right" boundary stencil (start of signal)
        ext_pts = grid[d:-d]

        # one-sided extrapolations from each boundary
        Vl = np.stack(
            [((left_pts - left_pts[0]) / max(total, 1)) ** k for k in range(d)],
            axis=1,
        )
        Vr = np.stack(
            [((right_pts - right_pts[0]) / max(total, 1)) ** k for k in range(d)],
            axis=1,
        )
        El = np.stack(
            [((ext_pts - left_pts[0]) / max(total, 1)) ** k for k in range(d)],
            axis=1,
        )
        Er = np.stack(
            [((ext_pts - right_pts[0]) / max(total, 1)) ** k for k in range(d)],
            axis=1,
        )
        from_left = El @ np.linalg.pinv(Vl)    # (n_add, d): extrapolate left stencil
        from_right = Er @ np.linalg.pinv(Vr)   # (n_add, d)
        # smooth blend: weight goes from right-side extrapolant to left-side
        s = (ext_pts - ext_pts[0]) / (ext_pts[-1] - ext_pts[0])
        w = 0.5 * (1 - np.cos(np.pi * s))  # 0 -> 1 smoothly
        B = np.zeros((n_add, 2 * d))
        B[:, :d] = (1 - w)[:, None] * from_left
        B[:, d:] = w[:, None] * from_right
        return B
