"""Finite-difference and spectral differentiation (port of
``neuraloperator_tpu/losses/differentiation.py``).

``FiniteDiff``: first and second derivatives along each of 1, 2 or 3
trailing spatial axes, 2nd-order central in the interior, periodic by roll
or with the 3rd-order one-sided boundary stencils, and the laplacian,
gradient, divergence and curl built from them. ``central_diff_{1,2,3}d``:
the free central differences. ``FourierDiff``: spectral derivatives by
``torch.fft`` with optional Fourier continuation and low-pass filtering.
``get_non_uniform_fd_weights`` / ``non_uniform_fd``: least-squares stencils
on point clouds.
"""

import math
from typing import Sequence, Union

import numpy as np
import torch


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
    Vector fields carry their components on axis ``-dim - 1``.
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

    def _d(self, u, i: int, order: int = 1):
        return _diff_axis(u, self.h[i], self._axis(i), order, self.periodic[i])

    def dx(self, u, order: int = 1):
        return self._d(u, 0, order)

    def dy(self, u, order: int = 1):
        if self.dim < 2:
            raise ValueError("dy is only available for 2D and 3D")
        return self._d(u, 1, order)

    def dz(self, u, order: int = 1):
        if self.dim < 3:
            raise ValueError("dz is only available for 3D")
        return self._d(u, 2, order)

    def laplacian(self, u):
        out = self.dx(u, 2)
        if self.dim >= 2:
            out = out + self.dy(u, 2)
        if self.dim >= 3:
            out = out + self.dz(u, 2)
        return out

    def gradient(self, u):
        parts = [self._d(u, i) for i in range(self.dim)]
        if self.dim == 1:
            return parts[0]
        return torch.stack(parts, dim=-self.dim - 1)

    def divergence(self, v):
        """``v``: a vector field with components stacked on axis ``-dim-1``."""
        out = self._d(v.select(-self.dim - 1, 0), 0)
        for i in range(1, self.dim):
            out = out + self._d(v.select(-self.dim - 1, i), i)
        return out

    def curl(self, v):
        if self.dim == 2:
            vx, vy = v.select(-3, 0), v.select(-3, 1)
            return self._d(vy, 0) - self._d(vx, 1)
        if self.dim == 3:
            vx, vy, vz = (v.select(-4, i) for i in range(3))
            dx = lambda u: self._d(u, 0)  # noqa: E731
            dy = lambda u: self._d(u, 1)  # noqa: E731
            dz = lambda u: self._d(u, 2)  # noqa: E731
            return torch.stack([dy(vz) - dz(vy), dz(vx) - dx(vz), dx(vy) - dy(vx)], dim=-4)
        raise ValueError("curl requires dim 2 or 3")


def _one_sided(x: torch.Tensor, d: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """``d`` with its two boundary values along ``axis`` replaced by
    first-order one-sided differences of ``x``."""
    n = x.shape[axis]
    left = (x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)) / h
    right = (x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)) / h
    return torch.cat([left, d.narrow(axis, 1, n - 2), right], dim=axis)


def _central_first(x: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    return (torch.roll(x, -1, axis) - torch.roll(x, 1, axis)) / (2 * h)


def central_diff_1d(x, h, fix_x_bnd=False):
    """2nd-order central difference along the last dim; ``fix_x_bnd``
    replaces the periodic boundary values by one-sided ones."""
    dx = _central_first(x, -1, h)
    return _one_sided(x, dx, -1, h) if fix_x_bnd else dx


def central_diff_2d(x, h, fix_x_bnd=False, fix_y_bnd=False):
    """Central differences along the last two dims: ``(dx, dy)``."""
    if isinstance(h, (int, float)):
        h = (h, h)
    dx, dy = _central_first(x, -2, h[0]), _central_first(x, -1, h[1])
    if fix_x_bnd:
        dx = _one_sided(x, dx, -2, h[0])
    if fix_y_bnd:
        dy = _one_sided(x, dy, -1, h[1])
    return dx, dy


def central_diff_3d(x, h, fix_x_bnd=False, fix_y_bnd=False, fix_z_bnd=False):
    """Central differences along the last three dims: ``(dx, dy, dz)``."""
    if isinstance(h, (int, float)):
        h = (h, h, h)
    out = []
    for fix, ax, hh in ((fix_x_bnd, -3, h[0]), (fix_y_bnd, -2, h[1]), (fix_z_bnd, -1, h[2])):
        d = _central_first(x, ax, hh)
        out.append(_one_sided(x, d, ax, hh) if fix else d)
    return tuple(out)


class FourierDiff:
    """1/2/3-D spectral differentiation: derivatives of periodic signals by
    multiplication with ``(ik)^n`` in Fourier space, with optional Fourier
    continuation (``use_fc`` True or "legendre", or "gram") for
    non-periodic data and an optional low-pass filter. ``dx``
    differentiates the first spatial axis (axis ``-dim``), ``dy`` the next,
    ``dz`` the last. ``L`` is the domain length, one or one per axis.

    As in the JAX package, the multiplier is a real amplitude
    ``prod_j k_j^{o_j}`` (float32) and a quarter-turn phase ``i^{sum o_j}``
    applied as a rotation of the (re, im) parts, and the transform runs on
    the float32 input.
    """

    def __init__(self, dim: int, L=None, use_fc=False, fc_degree: int = 4,
                 fc_n_additional_pts: int = 50, low_pass_filter_ratio=None):
        if dim not in (1, 2, 3):
            raise ValueError("dim must be 1, 2, or 3")
        self.dim = dim
        if L is None:
            L = 2 * math.pi
        if not isinstance(L, (tuple, list)):
            L = (float(L),) * dim
        if len(L) != dim:
            raise ValueError(f"For {dim}D, L must be a single float or a {dim}-tuple")
        self.L = tuple(float(v) for v in L)
        self.use_fc = use_fc
        self.fc_degree = fc_degree
        self.fc_n_additional_pts = fc_n_additional_pts
        self.low_pass_filter_ratio = low_pass_filter_ratio

        self.FC = None
        if use_fc:
            from ..layers.fourier_continuation import FCGram, FCLegendre

            name = "legendre" if use_fc is True else str(use_fc).lower()
            if name == "legendre":
                self.FC = FCLegendre(d=fc_degree, n_additional_pts=fc_n_additional_pts)
            elif name == "gram":
                self.FC = FCGram(d=fc_degree, n_additional_pts=fc_n_additional_pts)
            else:
                raise ValueError(
                    f"Given FC input {use_fc!r} is not valid. Must be 'legendre' or 'gram'."
                )

    def compute_multiple_derivatives(self, u, derivatives):
        """Several derivatives from one forward FFT: ``derivatives`` is a
        list of int orders (1-D) or order tuples (2/3-D), e.g.
        ``[(1, 0), (0, 1)]``; returns a list of real tensors in that order."""
        orders = [(int(o),) if isinstance(o, (int, np.integer)) else tuple(o)
                  for o in derivatives]
        for o in orders:
            if len(o) != self.dim:
                raise ValueError(
                    f"For {self.dim}D, each derivative spec needs {self.dim} orders, got {o}"
                )
        axes = list(range(-self.dim, 0))
        sizes = [u.shape[a] for a in axes]
        L = list(self.L)
        if self.FC is not None:
            # the FC layer's own point count: FCGram makes an odd count even
            extra = self.FC.n_additional_pts
            u = self.FC.extend(u, dim=self.dim)
            L = [length * (n + extra) / n for length, n in zip(L, sizes)]
            sizes = [u.shape[a] for a in axes]

        uh = torch.fft.fftn(u.float(), dim=axes)
        ur, ui = uh.real, uh.imag
        ks = [2 * np.pi * np.fft.fftfreq(n, d=length / n) for n, length in zip(sizes, L)]
        if self.low_pass_filter_ratio is not None:
            # zero |frequency index| >= int((n // 2 + 1) * ratio), per axis
            for j, n in enumerate(sizes):
                cutoff = int((n // 2 + 1) * self.low_pass_filter_ratio)
                idx = np.minimum(np.arange(n), n - np.arange(n))
                shape = [1] * u.dim()
                shape[axes[j]] = n
                f = torch.from_numpy((idx < cutoff).astype(np.float32).reshape(shape))
                f = f.to(u.device)
                ur, ui = ur * f, ui * f

        outs = []
        for o in orders:
            K = np.ones((), np.float32)
            for j, (k, oj, n) in enumerate(zip(ks, o, sizes)):
                if oj == 0:
                    continue
                shape = [1] * self.dim
                shape[j] = n
                K = K * (k.astype(np.float64) ** oj).reshape(shape)
            K = torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(K, sizes).astype(np.float32)))
            K = K.reshape((1,) * (u.dim() - self.dim) + tuple(sizes)).to(u.device)
            phase = sum(o) % 4
            if phase == 0:
                dr, di = ur * K, ui * K
            elif phase == 1:
                dr, di = -ui * K, ur * K
            elif phase == 2:
                dr, di = -ur * K, -ui * K
            else:
                dr, di = ui * K, -ur * K
            out = torch.fft.ifftn(torch.complex(dr, di), dim=axes).real
            if self.FC is not None:
                out = self.FC.restrict(out, dim=self.dim)
            outs.append(out)
        return outs

    def derivative(self, u, order):
        """The derivative of an order tuple, e.g. ``(1, 0)`` = d/dx in 2-D."""
        order = tuple(order)
        if len(order) != self.dim:
            raise ValueError(f"For {self.dim}D, order must be a tuple with {self.dim} elements")
        return self.compute_multiple_derivatives(u, [order])[0]

    def partial(self, u, direction: str = "x", order: int = 1):
        """The partial derivative along a named direction."""
        if direction == "x":
            return self.dx(u, order=order)
        if direction == "y" and self.dim >= 2:
            return self.dy(u, order=order)
        if direction == "z" and self.dim >= 3:
            return self.dz(u, order=order)
        raise ValueError(f"Invalid direction '{direction}' for dimension {self.dim}")

    def _unit(self, axis: int, order: int):
        o = [0] * self.dim
        o[axis] = order
        return tuple(o)

    def dx(self, u, order: int = 1):
        return self.derivative(u, self._unit(0, order))

    def dy(self, u, order: int = 1):
        if self.dim < 2:
            raise ValueError("dy method only available for 2D and 3D")
        return self.derivative(u, self._unit(1, order))

    def dz(self, u, order: int = 1):
        if self.dim < 3:
            raise ValueError("dz method only available for 3D")
        return self.derivative(u, self._unit(2, order))

    def laplacian(self, u):
        """The sum of the second derivatives, from one FFT."""
        parts = self.compute_multiple_derivatives(u, [self._unit(j, 2) for j in range(self.dim)])
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def gradient(self, u):
        """The gradient stacked on axis ``-dim-1``."""
        parts = self.compute_multiple_derivatives(u, [self._unit(j, 1) for j in range(self.dim)])
        if self.dim == 1:
            return parts[0][..., None, :]
        return torch.stack(parts, dim=-self.dim - 1)

    def _components(self, u):
        if u.shape[-self.dim - 1] != self.dim:
            raise ValueError(
                f"For {self.dim}D, input must have {self.dim} components in the vector dimension"
            )
        return [u.select(-self.dim - 1, j) for j in range(self.dim)]

    def divergence(self, u):
        """The divergence of a field with components on axis ``-dim-1``."""
        comps = self._components(u)
        out = self.dx(comps[0])
        if self.dim >= 2:
            out = out + self.dy(comps[1])
        if self.dim >= 3:
            out = out + self.dz(comps[2])
        return out

    def curl(self, u):
        """The curl: a scalar in 2-D, a vector on axis -4 in 3-D."""
        if self.dim == 1:
            raise ValueError("curl not defined for 1D")
        comps = self._components(u)
        if self.dim == 2:
            return self.dx(comps[1]) - self.dy(comps[0])
        cx = self.dy(comps[2]) - self.dz(comps[1])
        cy = self.dz(comps[0]) - self.dx(comps[2])
        cz = self.dx(comps[1]) - self.dy(comps[0])
        return torch.stack([cx, cy, cz], dim=-4)


def get_non_uniform_fd_weights(points, num_neighbors=5, derivative_indices=(0,), radius=None,
                               regularize_lstsq=False):
    """Least-squares first-derivative stencils on a point cloud.

    For each of the N points (``points``: (N, d)), weights over its k
    nearest neighbors (itself first) that are consistent to first order.
    Returns (indices (N, k), weights (N, n_derivs, k)). The least squares
    run through ``torch.linalg.pinv`` at the JAX package's cut-off
    (``10 * max(m, n) * eps``), or with ``regularize_lstsq`` through the
    normal equations with a 1e-6 ridge and ``torch.linalg.solve``.
    """
    points = torch.as_tensor(points)
    N, d = points.shape
    k = min(max(num_neighbors, 3), N)
    d2 = torch.sum((points[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    neg_d2, indices = torch.topk(-d2, k, dim=-1)
    distances = torch.sqrt(torch.clamp(-neg_d2, min=0.0))
    if radius is None:
        mask = torch.ones_like(distances, dtype=torch.bool)
    else:
        mask = distances <= radius
        mask[:, :3] = True

    # A: (N, d+1, k), the consistency conditions [sum w = 0; sum w dx_j = e_j]
    rows = [torch.ones((N, k), dtype=points.dtype, device=points.device)]
    for i in range(d):
        rows.append(points[indices, i] - points[:, i][:, None])
    A = torch.stack(rows, dim=1) * mask[:, None, :]
    n_derivs = len(derivative_indices)
    A = A[:, None].expand(N, n_derivs, *A.shape[1:])
    b = torch.zeros((n_derivs, d + 1, 1), dtype=points.dtype, device=points.device)
    for j, di in enumerate(derivative_indices):
        b[j, di + 1, 0] = 1.0
    b = b[None].expand(N, *b.shape)
    if regularize_lstsq:
        AT = A.transpose(-2, -1)
        AtA = AT @ A + 1e-6 * torch.eye(k, dtype=A.dtype, device=A.device)
        w = torch.linalg.solve(AtA, AT @ b)[..., 0]
    else:
        rtol = 10.0 * max(A.shape[-2:]) * torch.finfo(A.dtype).eps
        w = (torch.linalg.pinv(A, rtol=rtol) @ b)[..., 0]
    return indices, w


def non_uniform_fd(points, values, num_neighbors=5, derivative_indices=(0,), radius=None,
                   regularize_lstsq=False):
    """First derivatives of ``values`` (N,) on a point cloud: (n_derivs, N)."""
    indices, fd_weights = get_non_uniform_fd_weights(
        points=points, num_neighbors=num_neighbors, derivative_indices=derivative_indices,
        radius=radius, regularize_lstsq=regularize_lstsq)
    values = torch.as_tensor(values)
    return torch.einsum("nij,nj->in", fd_weights, values[indices])
