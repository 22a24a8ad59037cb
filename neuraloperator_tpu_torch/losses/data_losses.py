"""Data losses (port of ``neuraloperator_tpu/losses/data_losses.py``).

``LpLoss`` and ``H1Loss`` with the JAX package's quadrature and reduction
semantics: spatial dims are quadrature-weighted (absolute norms) or cancel
(relative norms), and ``reduction`` ("sum" or "mean") applies over the
batch and channel dims. ``H1Loss`` takes a precomputed ``ynorm_sq`` (the
relative denominator) and then runs one stencil pass on the difference.
"""

import math
from typing import List

import torch

from .._common import not_ported
from .differentiation import FiniteDiff


def _flatten_spatial(x: torch.Tensor, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-d], -1)


def _quadrature(loss, x, quadrature) -> List[float]:
    if quadrature is None:
        return loss.uniform_quadrature(x)
    if isinstance(quadrature, float):
        return [quadrature] * loss.d
    return quadrature


class LpLoss:
    """Relative or absolute Lp norm between discretized d-dim functions."""

    def __init__(self, d=1, p=2, measure=1.0, reduction="sum", eps=1e-8):
        if reduction not in ("sum", "mean"):
            raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
        self.d = d
        self.p = p
        self.eps = eps
        self.reduction = reduction
        self.measure = [measure] * d if isinstance(measure, (int, float)) else list(measure)

    @property
    def name(self):
        return f"L{self.p}_{self.d}Dloss"

    def uniform_quadrature(self, x) -> List[float]:
        return [self.measure[-j] / x.shape[-j] for j in range(self.d, 0, -1)][::-1]

    def reduce_all(self, x):
        return torch.sum(x) if self.reduction == "sum" else torch.mean(x)

    def _pow_sum(self, flat):
        if self.p == 1:
            return torch.sum(torch.abs(flat), dim=-1)
        if self.p % 2 == 0:
            return torch.sum(flat ** self.p, dim=-1)
        return torch.sum(torch.abs(flat) ** self.p, dim=-1)

    def abs(self, x, y, quadrature=None, take_root=True):
        const = math.prod(_quadrature(self, x, quadrature))
        diff = const * self._pow_sum(
            _flatten_spatial(x, self.d) - _flatten_spatial(y, self.d)
        )
        if take_root and self.p != 1:
            diff = diff ** (1.0 / self.p)
        return torch.squeeze(self.reduce_all(diff))

    def rel(self, x, y, take_root=True):
        diff = self._pow_sum(_flatten_spatial(x, self.d) - _flatten_spatial(y, self.d))
        ynorm = self._pow_sum(_flatten_spatial(y, self.d))
        if take_root and self.p != 1:
            diff = (diff ** (1.0 / self.p)) / (ynorm ** (1.0 / self.p) + self.eps)
        else:
            diff = diff / (ynorm + self.eps)
        return torch.squeeze(self.reduce_all(diff))

    def __call__(self, y_pred, y, **kwargs):
        return self.rel(y_pred, y)


class H1Loss:
    """Relative or absolute H1 Sobolev norm via finite-difference gradients."""

    def __init__(
        self,
        d=1,
        measure=1.0,
        reduction="sum",
        eps=1e-8,
        periodic_in_x=True,
        periodic_in_y=True,
        periodic_in_z=True,
    ):
        if not 0 < d < 4:
            raise ValueError("H1Loss is implemented for d in {1, 2, 3}")
        if reduction not in ("sum", "mean"):
            raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
        self.d = d
        self.eps = eps
        self.reduction = reduction
        self.measure = [measure] * d if isinstance(measure, (int, float)) else list(measure)
        self.periodic = (periodic_in_x, periodic_in_y, periodic_in_z)

    @property
    def name(self):
        return f"H1_{self.d}DLoss"

    def uniform_quadrature(self, x) -> List[float]:
        return [self.measure[-j] / x.shape[-j] for j in range(self.d, 0, -1)][::-1]

    def reduce_all(self, x):
        return torch.sum(x) if self.reduction == "sum" else torch.mean(x)

    def _term_list(self, x, quadrature):
        fd = FiniteDiff(
            dim=self.d,
            h=quadrature[0] if self.d == 1 else quadrature,
            periodic_in_x=self.periodic[0],
            periodic_in_y=self.periodic[1],
            periodic_in_z=self.periodic[2],
        )
        derivs = [fd.dx, fd.dy, fd.dz][:self.d]
        return [_flatten_spatial(x, self.d)] + [
            _flatten_spatial(dfn(x), self.d) for dfn in derivs
        ]

    def ynorm_sq(self, y, quadrature=None):
        """Per-sample sum of the squared H1 terms of ``y``: ``rel``'s
        denominator before the root, which depends on the target alone."""
        ty = self._term_list(y, _quadrature(self, y, quadrature))
        return sum(torch.sum(b ** 2, dim=-1) for b in ty)

    def abs(self, x, y, quadrature=None, take_root=True):
        quadrature = _quadrature(self, x, quadrature)
        tx, ty = self._term_list(x, quadrature), self._term_list(y, quadrature)
        const = math.prod(quadrature)
        diff = sum(const * torch.sum((a - b) ** 2, dim=-1) for a, b in zip(tx, ty))
        if take_root:
            diff = diff ** 0.5
        return torch.squeeze(self.reduce_all(diff))

    def rel(self, x, y, quadrature=None, take_root=True, ynorm_sq=None):
        quadrature = _quadrature(self, x, quadrature)
        if ynorm_sq is None:
            tx, ty = self._term_list(x, quadrature), self._term_list(y, quadrature)
            diff = sum(torch.sum((a - b) ** 2, dim=-1) for a, b in zip(tx, ty))
            ynorm = sum(torch.sum(b ** 2, dim=-1) for b in ty)
        else:
            # finite differences are linear, d(x) - d(y) = d(x - y): with the
            # denominator given, one stencil pass on the difference is enough
            td = self._term_list(x - y, quadrature)
            diff = sum(torch.sum(a ** 2, dim=-1) for a in td)
            ynorm = ynorm_sq
        if take_root:
            diff = (diff ** 0.5) / (ynorm ** 0.5 + self.eps)
        else:
            diff = diff / (ynorm + self.eps)
        return torch.squeeze(self.reduce_all(diff))

    def __call__(self, y_pred, y, quadrature=None, ynorm_sq=None, **kwargs):
        return self.rel(y_pred, y, quadrature=quadrature, ynorm_sq=ynorm_sq)


def _unported(name: str):
    def __init__(self, *args, **kwargs):
        raise not_ported(name, "the rest of losses, training and data")

    return type(name, (), {"__init__": __init__, "__doc__": f"{name}: not ported yet."})


HdivLoss = _unported("HdivLoss")
MSELoss = _unported("MSELoss")
PointwiseQuantileLoss = _unported("PointwiseQuantileLoss")
