"""Data losses (port of ``neuraloperator_tpu/losses/data_losses.py``).

``LpLoss`` and ``H1Loss`` with the JAX package's quadrature and reduction
semantics: spatial dims are quadrature-weighted (absolute norms) or cancel
(relative norms), and ``reduction`` ("sum" or "mean") applies over the
batch and channel dims. ``H1Loss`` takes a precomputed ``ynorm_sq`` (the
relative denominator) and then runs one stencil pass on the difference.
``HdivLoss`` (values plus divergence), ``MSELoss`` and
``PointwiseQuantileLoss`` complete the set.
"""

import math
from typing import List

import torch

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


class HdivLoss:
    """Relative or absolute H(div) norm between vector fields with their
    components on the channel dim: the l2 of the values (over components
    and points) plus the l2 of the divergence (``FiniteDiff``, periodic or
    one-sided per axis)."""

    def __init__(self, d=2, measure=1.0, reduction="sum", eps=1e-8, periodic_in_x=True,
                 periodic_in_y=True, periodic_in_z=True):
        if not 0 < d < 4:
            raise ValueError(f"d must be 1, 2 or 3, got {d}")
        if reduction not in ("sum", "mean"):
            raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
        self.d = d
        self.eps = eps
        self.reduction = reduction
        self.measure = [measure] * d if isinstance(measure, (int, float)) else list(measure)
        self.periodic = (periodic_in_x, periodic_in_y, periodic_in_z)

    @property
    def name(self):
        return f"Hdiv_{self.d}DLoss"

    def uniform_quadrature(self, x) -> List[float]:
        return [self.measure[-j] / x.shape[-j] for j in range(self.d, 0, -1)][::-1]

    def reduce_all(self, x):
        return torch.sum(x) if self.reduction == "sum" else torch.mean(x)

    def _terms(self, x, y, quadrature):
        """(values, divergences) of x and y, each flattened over space."""
        fd = FiniteDiff(dim=self.d, h=quadrature[0] if self.d == 1 else quadrature,
                        periodic_in_x=self.periodic[0], periodic_in_y=self.periodic[1],
                        periodic_in_z=self.periodic[2])
        return [_flatten_spatial(t, self.d)
                for t in (x, y, fd.divergence(x), fd.divergence(y))]

    def rel(self, x, y, quadrature=None, take_root=True):
        quadrature = _quadrature(self, x, quadrature)
        xf, yf, dx, dy = self._terms(x, y, quadrature)
        diff = torch.sum((xf - yf) ** 2, dim=(-1, -2)) + torch.sum((dx - dy) ** 2, dim=-1)
        ynorm = torch.sum(yf ** 2, dim=(-1, -2)) + torch.sum(dy ** 2, dim=-1)
        if take_root:
            diff = (diff ** 0.5) / (ynorm ** 0.5 + self.eps)
        else:
            diff = diff / (ynorm + self.eps)
        return torch.squeeze(self.reduce_all(diff))

    def abs(self, x, y, quadrature=None, take_root=True):
        quadrature = _quadrature(self, x, quadrature)
        xf, yf, dx, dy = self._terms(x, y, quadrature)
        diff = math.prod(quadrature) * (torch.sum((xf - yf) ** 2, dim=(-1, -2))
                                        + torch.sum((dx - dy) ** 2, dim=-1))
        if take_root:
            diff = diff ** 0.5
        return torch.squeeze(self.reduce_all(diff))

    def __call__(self, y_pred, y, quadrature=None, **kwargs):
        return self.rel(y_pred, y, quadrature=quadrature)


class MSELoss:
    """Mean squared error: over everything ("mean"), or each sample's mean
    summed over the batch ("sum")."""

    def __init__(self, reduction="mean"):
        if reduction not in ("sum", "mean"):
            raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
        self.reduction = reduction

    @property
    def name(self):
        return "MSELoss"

    def __call__(self, y_pred, y, **kwargs):
        se = (y_pred - y) ** 2
        if self.reduction == "mean":
            return torch.mean(se)
        return torch.sum(torch.mean(se.reshape(se.shape[0], -1), dim=-1))


class PointwiseQuantileLoss:
    """Quantile (pinball) loss of a predicted band ``y_pred`` against the
    point errors ``y``: the mean over each sample's points of
    ``max(q (|y| - y_pred), (1 - q) (y_pred - |y|))``, q = 1 - alpha,
    summed ("sum") or averaged ("mean") over the samples."""

    def __init__(self, alpha: float, reduction="sum"):
        if reduction not in ("sum", "mean"):
            raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
        self.alpha = alpha
        self.reduction = reduction

    @property
    def name(self):
        return "PointwiseQuantileLoss"

    def __call__(self, y_pred, y, **kwargs):
        quantile = 1.0 - self.alpha
        yscale = torch.abs(y)
        ptwise = torch.maximum(quantile * (yscale - y_pred), (1 - quantile) * (y_pred - yscale))
        per_sample = torch.mean(ptwise.reshape(ptwise.shape[0], -1), dim=-1, keepdim=True)
        if self.reduction == "sum":
            return torch.squeeze(torch.sum(per_sample))
        return torch.squeeze(torch.mean(per_sample))

