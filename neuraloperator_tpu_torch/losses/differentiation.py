"""Finite differences (port of ``neuraloperator_tpu/losses/differentiation.py``).

``FiniteDiff`` as far as ``H1Loss`` uses it: first derivatives (and the
second-order stencils of ``_diff_axis``) along each of 1, 2 or 3 trailing
spatial axes, 2nd-order central in the interior, periodic by roll or with
the 3rd-order one-sided boundary stencils.
"""

from typing import Sequence, Union

import torch

from .._common import not_ported


def _central(u: torch.Tensor, h: float, axis: int, order: int) -> torch.Tensor:
    up = torch.roll(u, -1, axis)
    um = torch.roll(u, 1, axis)
    if order == 1:
        return (up - um) / (2 * h)
    return (up - 2 * u + um) / (h * h)


def _diff_axis(u: torch.Tensor, h: float, axis: int, order: int, periodic: bool):
    """Finite difference of ``u`` along ``axis`` (see the module docstring)."""
    d = _central(u, h, axis, order)
    if periodic:
        return d
    n = u.shape[axis]
    f = lambda i: u.narrow(axis, i, 1)  # noqa: E731
    g = lambda i: u.narrow(axis, n + i, 1)  # noqa: E731
    if order == 1:
        left = (-11 * f(0) + 18 * f(1) - 9 * f(2) + 2 * f(3)) / (6 * h)
        right = (-2 * g(-4) + 9 * g(-3) - 18 * g(-2) + 11 * g(-1)) / (6 * h)
    elif order == 2:
        left = (2 * f(0) - 5 * f(1) + 4 * f(2) - f(3)) / (h * h)
        right = (-g(-4) + 4 * g(-3) - 5 * g(-2) + 2 * g(-1)) / (h * h)
    else:
        raise ValueError("order must be 1 or 2")
    mid = d.narrow(axis, 1, n - 2)
    return torch.cat([left, mid, right], dim=axis)


class FiniteDiff:
    """1/2/3-D finite differences: ``dx`` along axis ``-dim``, ``dy`` along
    ``-dim + 1``, ``dz`` along ``-1``; ``h`` is one spacing or one per axis.
    """

    def __init__(
        self,
        dim: int,
        h: Union[float, Sequence[float]] = 1.0,
        periodic_in_x: bool = True,
        periodic_in_y: bool = True,
        periodic_in_z: bool = True,
    ):
        if dim not in (1, 2, 3):
            raise ValueError("dim must be 1, 2, or 3")
        self.dim = dim
        if isinstance(h, (int, float)):
            self.h = tuple(float(h) for _ in range(dim))
        else:
            if len(h) != dim:
                raise ValueError(f"h must be a float or length-{dim} sequence")
            self.h = tuple(float(v) for v in h)
        self.periodic = (periodic_in_x, periodic_in_y, periodic_in_z)[:dim]

    def _axis(self, i: int) -> int:
        return -self.dim + i

    def dx(self, u, order: int = 1):
        return _diff_axis(u, self.h[0], self._axis(0), order, self.periodic[0])

    def dy(self, u, order: int = 1):
        if self.dim < 2:
            raise ValueError("dy is only available for 2D and 3D")
        return _diff_axis(u, self.h[1], self._axis(1), order, self.periodic[1])

    def dz(self, u, order: int = 1):
        if self.dim < 3:
            raise ValueError("dz is only available for 3D")
        return _diff_axis(u, self.h[2], self._axis(2), order, self.periodic[2])

    def laplacian(self, u):
        raise not_ported("FiniteDiff.laplacian",
                         "the rest of losses, training and data")

    def gradient(self, u):
        raise not_ported("FiniteDiff.gradient",
                         "the rest of losses, training and data")

    def divergence(self, v):
        raise not_ported("FiniteDiff.divergence",
                         "the rest of losses, training and data")

    def curl(self, v):
        raise not_ported("FiniteDiff.curl", "the rest of losses, training and data")
