"""Spherical harmonic transforms (port of ``neuraloperator_tpu/ops/sht.py``).

The real SHT is a truncated real DFT along the longitude followed by an
associated-Legendre matmul along the latitude, per order m. The Legendre
matrices are built on the host in float64 numpy with the stable normalized
recurrences of the JAX module (a copy: the port imports nothing of it),
cast to float32, and cached per (nlat, lmax, mmax, grid); their tensors are
cached once per device and dtype.

Conventions: orthonormal spherical harmonics ``Y_lm = Pbar_l^m(cos θ)
e^{imφ}`` with the Condon-Shortley phase; coefficients ``f_lm = ∫ f Y_lm*
dΩ`` for m >= 0 (a real field's negative orders are conjugates). Grids:
"legendre-gauss" (exact quadrature) and "equiangular" (cell-centred
colatitudes with Fejér-1 weights).

Precision: the longitude transforms are the port's DFT matmuls
(``ops/fourier.py``), f32-accurate with TF32 off, as the JAX package asks
for ``Precision.HIGH`` there. The two Legendre einsums carry no precision,
in JAX as here: they follow the process's float32 matmul precision
(``training.setup``).
"""

import functools
from typing import Tuple

import numpy as np
import torch

from .complex_einsum import Operand, split_complex
from .fourier import rdft_gather_last, rdft_scatter_last


def _normalized_legendre(lmax: int, mmax: int, x: np.ndarray) -> np.ndarray:
    """``Pbar[l, m, j]`` at ``x_j = cos(theta_j)``, orthonormal:
    ``2π ∫ Pbar_l^m(x)^2 dx = 1``; the stable recurrence over l for each m."""
    nlat = x.shape[0]
    P = np.zeros((lmax, mmax, nlat))
    sx = np.sqrt(np.clip(1.0 - x * x, 0.0, None))
    # seed: Pbar_0^0 = sqrt(1/4π)
    pmm = np.full(nlat, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(mmax):
        if m > 0:
            pmm = -np.sqrt((2 * m + 1.0) / (2.0 * m)) * sx * pmm
        if m < lmax:
            P[m, m] = pmm
        if m + 1 < lmax:
            P[m + 1, m] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[l, m] = a * (x * P[l - 1, m] - b * P[l - 2, m])
    return P


def _quadrature(nlat: int, grid: str) -> Tuple[np.ndarray, np.ndarray]:
    """Colatitude cosines ``x_j`` and weights ``w_j`` with ``Σ w_j f(x_j) ≈
    ∫_{-1}^1 f``, colatitude ascending (x from 1 to -1)."""
    if grid == "legendre-gauss":
        x, w = np.polynomial.legendre.leggauss(nlat)
        return x[::-1].copy(), w[::-1].copy()
    if grid == "equiangular":
        # cell-centred theta_j = pi (j + 1/2) / nlat, Fejér-1 weights in theta
        theta = np.pi * (np.arange(nlat) + 0.5) / nlat
        x = np.cos(theta)
        k = np.arange(1, nlat // 2 + 1)
        w = np.zeros(nlat)
        for j in range(nlat):
            w[j] = (2.0 / nlat) * (
                1.0 - 2.0 * np.sum(np.cos(2.0 * k * theta[j]) / (4.0 * k ** 2 - 1.0))
            )
        return x, w
    raise ValueError(f"unknown grid {grid!r}; use 'equiangular' or 'legendre-gauss'")


@functools.lru_cache(maxsize=32)
def _sht_matrices_np(nlat: int, lmax: int, mmax: int, grid: str):
    """(analysis[l, m, j] with the weights and 2π, synthesis[j, l, m]), float32."""
    x, w = _quadrature(nlat, grid)
    P = _normalized_legendre(lmax, mmax, x)
    analysis = 2.0 * np.pi * P * w[None, None, :]
    synthesis = np.transpose(P, (2, 0, 1))
    return np.asarray(analysis, np.float32), np.asarray(synthesis, np.float32)


@functools.lru_cache(maxsize=64)
def _sht_matrices(nlat: int, lmax: int, mmax: int, grid: str, device: torch.device,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two matrices on ``device`` as ``dtype``; built outside inference
    mode, as ``ops/fourier.py`` builds its DFT matrices, so that serving and
    training share them."""
    with torch.inference_mode(False):
        a, s = _sht_matrices_np(nlat, lmax, mmax, grid)
        return (torch.from_numpy(a).to(device=device, dtype=dtype),
                torch.from_numpy(s).to(device=device, dtype=dtype))


def sht(x: torch.Tensor, lmax: int, mmax: int, grid: str = "equiangular",
        norm: str = "ortho") -> torch.Tensor:
    """Real SHT: (..., nlat, nlon) real -> (..., lmax, mmax) complex.

    Only ``norm="ortho"``. The longitude DFT keeps ``min(mmax, nlon//2+1)``
    bins and zero-pads the rest up to ``mmax``.
    """
    if norm != "ortho":
        raise ValueError(f"only norm='ortho' is supported, got {norm!r}")
    nlat, nlon = x.shape[-2:]
    analysis, _ = _sht_matrices(nlat, lmax, mmax, grid, x.device, x.dtype)
    m_avail = min(mmax, nlon // 2 + 1)
    Fr, Fi = rdft_gather_last(x, m_avail, "forward")
    if m_avail < mmax:
        Fr = torch.nn.functional.pad(Fr, (0, mmax - m_avail))
        Fi = torch.nn.functional.pad(Fi, (0, mmax - m_avail))
    fr = torch.einsum("lmj,...jm->...lm", analysis, Fr)
    fi = torch.einsum("lmj,...jm->...lm", analysis, Fi)
    return torch.complex(fr, fi)


def isht(flm: Operand, nlat: int, nlon: int, grid: str = "equiangular",
         norm: str = "ortho") -> torch.Tensor:
    """Inverse real SHT: (..., lmax, mmax) coefficients -> (..., nlat, nlon) real.

    ``flm`` is a complex tensor or a ``(re, im)`` pair. Orders past
    ``nlon//2+1`` are dropped; the inverse longitude DFT enforces Hermitian
    symmetry (``rdft_scatter_last``).
    """
    if norm != "ortho":
        raise ValueError(f"only norm='ortho' is supported, got {norm!r}")
    re, im = split_complex(flm)
    _, synthesis = _sht_matrices(nlat, re.shape[-2], re.shape[-1], grid, re.device, re.dtype)
    Gr = torch.einsum("jlm,...lm->...jm", synthesis, re)
    Gi = torch.einsum("jlm,...lm->...jm", synthesis, im)
    half = nlon // 2 + 1
    if Gr.shape[-1] > half:
        Gr, Gi = Gr[..., :half], Gi[..., :half]
    return rdft_scatter_last(Gr, Gi, nlon, "forward")


__all__ = ["isht", "sht"]
