"""Gaussian normalization (port of ``neuraloperator_tpu/data/transforms/normalizers.py``).

Only ``transform`` and ``inverse_transform`` of fitted statistics are
ported; fitting belongs to the data path of the training slice.
"""

import numpy as np
import torch


class UnitGaussianNormalizer:
    """``(x - mean) / (std + eps)`` with statistics kept as numpy arrays.

    ``std + eps`` is formed in float64, as in the JAX package, before it is
    cast to the data's dtype; the statistics are copied to each device once.
    """

    def __init__(self, mean, std, eps: float = 1e-7):
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)
        self.eps = eps
        self._on_device = {}

    def _stats(self, x: torch.Tensor):
        key = (x.device, x.dtype)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.as_tensor(a, dtype=x.dtype).to(x.device)
                for a in (self.mean, self.std + self.eps)
            )
        return self._on_device[key]

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        mean, scale = self._stats(x)
        return (x - mean) / scale

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        mean, scale = self._stats(x)
        return x * scale + mean

    @classmethod
    def from_state_dict(cls, state: dict) -> "UnitGaussianNormalizer":
        return cls(state["mean"], state["std"], state.get("eps", 1e-7))
