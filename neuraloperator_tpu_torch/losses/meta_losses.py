"""Meta-losses (port of ``neuraloperator_tpu/losses/meta_losses.py``): weighted
sums, fieldwise aggregation and adaptive balancing.

SoftAdapt and ReLoBRaLo keep their loss histories as float64 numpy on the
host, as the JAX package does, so the weights they return are the JAX
package's to the bit for the same loss values; ReLoBRaLo's random lookback
draws from ``np.random.RandomState(seed)``. The weights are constants to
autograd (each loss is read with ``float``), and the returned weights are
a float32 tensor on the losses' device.
"""

from typing import Dict, Optional

import numpy as np
import torch


def _weights_tensor(lmbda: np.ndarray, like) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.tensor(lmbda, dtype=torch.float32, device=device)


class FieldwiseAggregatorLoss:
    """Per-field losses over index slices of the output: ``mappings`` maps
    each field to its index into ``pred`` and ``truth``, ``losses`` to its
    loss; the mean over the fields (and each field's loss with ``logging``)."""

    def __init__(self, losses: dict, mappings: dict, logging: bool = False):
        if mappings.keys() != losses.keys():
            raise ValueError("Mappings and losses must use the same keying")
        self.losses = losses
        self.mappings = mappings
        self.logging = logging

    def __call__(self, pred, truth, **kwargs):
        loss = 0.0
        loss_record = {}
        for field, indices in self.mappings.items():
            pred_field = pred[indices].reshape(-1, 1)
            truth_field = truth[indices]
            field_loss = self.losses[field](pred_field, truth_field)
            loss = loss + field_loss
            if self.logging:
                loss_record[field] = field_loss
        loss = loss / len(self.mappings)
        if self.logging:
            return loss, loss_record
        return loss


class WeightedSumLoss:
    """``sum_i weights[i] * losses[i](*args, **kwargs)``; equal weights
    summing to 1 by default."""

    def __init__(self, losses, weights=None):
        if weights is None:
            weights = [1.0 / len(losses)] * len(losses)
        if len(weights) != len(losses):
            raise ValueError("Each loss must have a weight.")
        self.losses = list(zip(losses, weights))

    def __call__(self, *args, **kwargs):
        total = 0.0
        for loss, weight in self.losses:
            total = total + weight * loss(*args, **kwargs)
        return total

    def __str__(self):
        return "Combined loss: " + " ".join(f"{loss} (weight: {w})" for loss, w in self.losses)


class Aggregator:
    """The base of adaptive balancing: fixed per-loss ``weights`` (1.0 for a
    loss not named) applied before the adaptive ones."""

    def __init__(self, params=None, num_losses: int = 2,
                 weights: Optional[Dict[str, float]] = None):
        self.num_losses = num_losses
        self.weights = weights

    def weigh_losses(self, losses: Dict) -> Dict:
        if self.weights is None:
            return losses
        w = dict(self.weights)
        for key in losses:
            w.setdefault(key, 1.0)
        return {k: w[k] * v for k, v in losses.items()}


class SoftAdapt(Aggregator):
    """SoftAdapt: each loss weighted by the softmax of its ratio to the
    previous call's value. ``__call__(losses, step)`` returns (the weighted
    total, the weights); step 0 records the losses and weighs them 1."""

    def __init__(self, params=None, num_losses=2, eps=1e-8, weights=None):
        super().__init__(params, num_losses, weights)
        self.eps = eps
        self.prev_losses = np.zeros(num_losses)

    def __call__(self, losses: Dict, step: int):
        losses = self.weigh_losses(losses)
        vals = list(losses.values())
        host_vals = np.array([float(v) for v in vals])
        if step == 0:
            self.prev_losses = host_vals.copy()
            return sum(vals), _weights_tensor(np.ones(self.num_losses), vals[0])

        normalizer = (host_vals / (self.prev_losses + self.eps)).max()
        lmbda = np.exp(host_vals / (self.prev_losses + self.eps) - normalizer)
        lmbda_sum = lmbda.sum()
        loss = sum(float(lam) * v for lam, v in zip(lmbda, vals))
        loss = loss * (self.num_losses / (lmbda_sum + self.eps))
        self.prev_losses = host_vals.copy()
        return loss, _weights_tensor(lmbda, vals[0])

    forward = __call__


class Relobralo(Aggregator):
    """ReLoBRaLo: SoftAdapt against the previous and the first losses,
    blended by an exponential moving average (``alpha``) whose lookback to
    the first losses fires with probability 1 - ``beta``."""

    def __init__(self, params=None, num_losses=2, alpha=0.95, beta=0.99, tau=1.0, eps=1e-8,
                 weights=None, seed: int = 0):
        super().__init__(params, num_losses, weights)
        self.alpha = alpha
        self.beta = beta
        self.tau = tau
        self.eps = eps
        self.init_losses = np.zeros(num_losses)
        self.prev_losses = np.zeros(num_losses)
        self.lmbda_ema = np.ones(num_losses)
        self._rng = np.random.RandomState(seed)

    def __call__(self, losses: Dict, step: int):
        losses = self.weigh_losses(losses)
        vals = list(losses.values())
        host_vals = np.array([float(v) for v in vals])
        if step == 0:
            self.init_losses = host_vals.copy()
            self.prev_losses = host_vals.copy()
            return sum(vals), _weights_tensor(self.lmbda_ema, vals[0])

        norm_prev = (host_vals / (self.tau * self.prev_losses + self.eps)).max()
        norm_init = (host_vals / (self.tau * self.init_losses + self.eps)).max()
        rho = float(self._rng.binomial(1, self.beta))
        lmbda_prev = np.exp(host_vals / (self.tau * self.prev_losses + self.eps) - norm_prev)
        lmbda_init = np.exp(host_vals / (self.tau * self.init_losses + self.eps) - norm_init)
        lmbda_prev *= self.num_losses / (lmbda_prev.sum() + self.eps)
        lmbda_init *= self.num_losses / (lmbda_init.sum() + self.eps)
        self.lmbda_ema = self.alpha * (rho * self.lmbda_ema + (1.0 - rho) * lmbda_init)
        self.lmbda_ema += (1.0 - self.alpha) * lmbda_prev

        loss = sum(float(lam) * v for lam, v in zip(self.lmbda_ema, vals))
        self.prev_losses = host_vals.copy()
        return loss, _weights_tensor(self.lmbda_ema, vals[0])

    forward = __call__
