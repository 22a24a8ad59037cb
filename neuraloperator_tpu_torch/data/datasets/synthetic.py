"""Host-side samplers for synthetic PDE data (port of ``gaussian_random_field``
of ``neuraloperator_tpu/data/datasets/synthetic.py``, unchanged numpy, so one
``rng`` draws the same fields in both packages)."""

import numpy as np


def gaussian_random_field(rng, n: int, alpha: float = 2.0, tau: float = 3.0):
    """Sample a GRF with covariance ~ (-Δ + tau^2)^(-alpha) on [0,1]^2."""
    k = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    sqrt_eig = (4 * np.pi ** 2 * (kx ** 2 + ky ** 2) + tau ** 2) ** (-alpha / 2.0)
    sqrt_eig[0, 0] = 0.0
    noise = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    field = np.fft.ifft2(noise * sqrt_eig).real
    field = field / (np.abs(field).max() + 1e-12)
    return field


__all__ = ["gaussian_random_field"]
