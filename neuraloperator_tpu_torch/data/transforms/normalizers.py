"""Gaussian normalization (port of ``neuraloperator_tpu/data/transforms/normalizers.py``).

``UnitGaussianNormalizer`` with dimension-reduced statistics, ``fit``,
streaming ``partial_fit`` and ``from_dataset``, and
``DictUnitGaussianNormalizer`` (one normalizer per key of a dict sample),
as in the JAX package. The
statistics are numpy arrays fitted on the host in float32 numpy, so both
packages fit the same numbers from the same data.
"""

import numpy as np
import torch


class UnitGaussianNormalizer:
    """``(x - mean) / (std + eps)`` over the reduction dims ``dim``.

    ``dim`` lists the dims reduced when fitting (e.g. ``[0, 2, 3]`` for
    channel-wise statistics of (b, c, h, w) data; all dims when None).
    ``std + eps`` is formed in numpy, as in the JAX package, before it is
    cast to the data's dtype; the statistics are copied to each device once,
    outside inference mode, so that serving and training can share them.
    """

    def __init__(self, mean=None, std=None, eps: float = 1e-7, dim=None):
        self.mean = None if mean is None else np.asarray(mean)
        self.std = None if std is None else np.asarray(std)
        self.eps = eps
        self.dim = list(dim) if dim is not None else None
        self.n_elements = 0
        self._on_device = {}

    def fit(self, data) -> "UnitGaussianNormalizer":
        self.n_elements = 0
        self.mean = None
        self.std = None
        self.partial_fit(data)
        return self

    def partial_fit(self, data, batch_size: int = 0) -> "UnitGaussianNormalizer":
        """Streaming mean/variance update (parallel-variance merge)."""
        del batch_size  # accepted for the JAX signature; the update is one pass
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, dtype=np.float32)
        dim = self.dim if self.dim is not None else list(range(data.ndim))
        count = int(np.prod([data.shape[d] for d in dim])) if dim else 1
        mean = data.mean(axis=tuple(dim), keepdims=True)
        var = data.var(axis=tuple(dim), keepdims=True)
        if self.n_elements == 0:
            self.mean, self._var, self.n_elements = mean, var, count
        else:
            n_a, n_b = self.n_elements, count
            mu_a, mu_b = self.mean, mean
            tot = n_a + n_b
            new_mean = (n_a * mu_a + n_b * mu_b) / tot
            new_var = (
                n_a * (self._var + (mu_a - new_mean) ** 2)
                + n_b * (var + (mu_b - new_mean) ** 2)
            ) / tot
            self.mean, self._var, self.n_elements = new_mean, new_var, tot
        self.std = np.sqrt(self._var)
        self._on_device = {}
        return self

    @classmethod
    def from_dataset(cls, dataset, dim=None, keys=("x", "y")):
        """Fit one normalizer per key over an iterable of dict samples."""
        normalizers = {k: cls(dim=dim) for k in keys}
        for sample in dataset:
            for k in keys:
                normalizers[k].partial_fit(np.asarray(sample[k])[None])
        return normalizers

    def _stats(self, x: torch.Tensor):
        if self.mean is None:
            raise RuntimeError("the normalizer has no statistics: fit it first")
        key = (x.device, x.dtype)
        if key not in self._on_device:
            with torch.inference_mode(False):
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

    __call__ = transform

    def state_dict(self) -> dict:
        """JSON-serializable fitted statistics (the checkpoint sidecar's)."""
        return {
            "mean": None if self.mean is None else np.asarray(self.mean).tolist(),
            "std": None if self.std is None else np.asarray(self.std).tolist(),
            "eps": float(self.eps),
            "dim": self.dim,
            "n_elements": int(self.n_elements),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "UnitGaussianNormalizer":
        norm = cls(
            mean=state.get("mean"),
            std=state.get("std"),
            eps=state.get("eps", 1e-7),
            dim=state.get("dim"),
        )
        norm.n_elements = int(state.get("n_elements", 0))
        if norm.std is not None:
            norm._var = norm.std ** 2
        return norm


class DictUnitGaussianNormalizer:
    """Per-key normalizers over dict samples: a key with a normalizer is
    transformed by it, any other passes through."""

    def __init__(self, normalizers: dict):
        self.normalizers = normalizers

    def transform(self, d: dict) -> dict:
        return {k: self.normalizers[k].transform(v) if k in self.normalizers else v
                for k, v in d.items()}

    def inverse_transform(self, d: dict) -> dict:
        return {k: self.normalizers[k].inverse_transform(v) if k in self.normalizers else v
                for k, v in d.items()}
