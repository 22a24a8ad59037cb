"""Divergence-free spectral projection, the Helmholtz–Hodge projection in
Fourier space (port of ``neuraloperator_tpu/layers/spectral_projection.py``):
``u_hat - k (k · u_hat) / |k|²`` on a (batch, 2, h, w) velocity field.

The projection keeps the spectrum of a real field Hermitian (``k`` is odd
in each frequency, the divergence's factor with it), and the Nyquist rows
and columns, which carry no direction, are zeroed; so the inverse rFFT
(cuFFT's C2R on the card) reads a Hermitian spectrum.
"""

import numpy as np
import torch


def projected_spectrum(u: torch.Tensor) -> torch.Tensor:
    """The divergence-free part of ``u``'s ``rfftn`` (norm "forward"),
    Nyquist rows and columns zeroed: (batch, 2, h, w // 2 + 1), complex."""
    b, c, h, w = u.shape
    if c != 2:
        raise ValueError(f"expects a 2-component velocity field, got {c} channels")
    uh = torch.fft.rfftn(u, dim=(-2, -1), norm="forward")
    kx = torch.from_numpy(np.fft.fftfreq(h, d=1.0 / h).astype(np.float32)).to(u.device)
    ky = torch.from_numpy(np.fft.rfftfreq(w, d=1.0 / w).astype(np.float32)).to(u.device)
    KX, KY = kx[:, None], ky[None, :]
    k2 = KX ** 2 + KY ** 2
    k2 = torch.where(k2 == 0, torch.ones_like(k2), k2)
    div = KX * uh[:, 0] + KY * uh[:, 1]
    proj = torch.stack([uh[:, 0] - KX * div / k2, uh[:, 1] - KY * div / k2], dim=1)
    nyquist = (KX.abs() == h // 2) | (KY == w // 2)
    return torch.where(nyquist[None, None], torch.zeros_like(proj), proj)


def spectral_projection_divergence_free(u: torch.Tensor) -> torch.Tensor:
    """u: (batch, 2, h, w) real velocity field -> its divergence-free
    projection, of the same shape."""
    h, w = u.shape[-2:]
    return torch.fft.irfftn(projected_spectrum(u), s=(h, w), dim=(-2, -1), norm="forward")
