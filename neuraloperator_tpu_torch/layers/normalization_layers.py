"""Normalization layers: AdaIN, InstanceNorm, GroupNorm, BatchNorm (port of
``neuraloperator_tpu/layers/normalization_layers.py``), channels first.

Parameters keep the JAX names (``scale``, ``bias``; AdaIN's ``mlp0`` and
``mlp1`` dense layers with ``kernel`` of shape (in, out) and ``bias``).
Variances are the biased (``ddof=0``) ones ``jnp.var`` takes.
"""

from typing import Optional

import torch
from torch import nn

from . import _init


def _normalize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    """Normalizes each (sample, channel) over the spatial dims; no affine."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(x, tuple(range(2, x.ndim)), self.eps)


class GroupNorm(nn.Module):
    """GroupNorm with a learnable per-channel ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, *,
                 device="cuda"):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = _init.constant((num_channels,), 1.0, device)
        self.bias = _init.constant((num_channels,), 0.0, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, *spatial = x.shape
        h = _normalize(x.reshape(b, self.num_groups, c // self.num_groups, -1), (2, 3), self.eps)
        shape = (1, c) + (1,) * len(spatial)
        return h.reshape(x.shape) * self.scale.reshape(shape) + self.bias.reshape(shape)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (in, out), lecun normal; ``bias`` zeros."""

    def __init__(self, in_features: int, out_features: int, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _init.lecun_normal((in_features, out_features), device, generator)
        self.bias = _init.constant((out_features,), 0.0, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class AdaIN(nn.Module):
    """Instance norm with a per-channel scale and shift made by an MLP from
    a conditioning embedding, which ``forward`` takes as an argument."""

    def __init__(self, embed_dim: int, in_channels: int, mlp_hidden: int = 512,
                 eps: float = 1e-5, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim, self.in_channels, self.eps = embed_dim, in_channels, eps
        self.mlp0 = Dense(embed_dim, mlp_hidden, device=device, generator=generator)
        self.mlp1 = Dense(mlp_hidden, 2 * in_channels, device=device, generator=generator)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        h = self.mlp0(embedding.reshape(self.embed_dim))
        h = self.mlp1(nn.functional.gelu(h, approximate="none"))
        weight, bias = h[: self.in_channels], h[self.in_channels:]
        shape = (1, self.in_channels) + (1,) * (x.ndim - 2)
        xhat = _normalize(x, tuple(range(2, x.ndim)), self.eps)
        return xhat * weight.reshape(shape) + bias.reshape(shape)


class BatchNorm(nn.Module):
    """Batch norm per channel over (batch, *spatial), with running statistics.

    ``scale`` and ``bias`` are parameters; the running ``mean`` (zeros) and
    ``var`` (ones) are buffers outside the ``state_dict``, as flax keeps them
    in a ``batch_stats`` collection outside ``params`` (which neither
    package's Trainer or checkpoints carry). ``forward`` normalizes with the
    batch's statistics and folds them into the running ones with
    ``momentum``, as the JAX module does when applied with
    ``mutable=["batch_stats"]``; ``use_running_average=True`` normalizes
    with the running statistics and leaves them alone.
    """

    def __init__(self, n_dim: int, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, *, device="cuda"):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = _init.constant((num_features,), 1.0, device)
        self.bias = _init.constant((num_features,), 0.0, device)
        zeros = torch.zeros(num_features, device=self.scale.device)
        self.register_buffer("mean", zeros, persistent=False)
        self.register_buffer("var", torch.ones_like(zeros), persistent=False)

    def forward(self, x: torch.Tensor, use_running_average: bool = False) -> torch.Tensor:
        shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * var)
        xhat = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return xhat * self.scale.reshape(shape) + self.bias.reshape(shape)
