"""Host-side synthetic PDE data (port of ``gaussian_random_field``,
``solve_darcy`` and ``generate_darcy_files`` of
``neuraloperator_tpu/data/datasets/synthetic.py``): unchanged numpy and
scipy, so one seed writes the same arrays to the bit in both packages."""

from pathlib import Path

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


def solve_darcy(a: np.ndarray, f: float = 1.0) -> np.ndarray:
    """Solve -div(a grad u) = f on the unit square, u=0 on the boundary.

    5-point finite volumes with harmonic-mean face coefficients; sparse
    direct solve. Small resolutions only (used for example data).
    """
    from scipy.sparse import lil_matrix
    from scipy.sparse.linalg import spsolve

    n = a.shape[0]
    h = 1.0 / (n + 1)
    N = n * n
    A = lil_matrix((N, N))
    b = np.full(N, f)

    def idx(i, j):
        return i * n + j

    def face(c1, c2):
        return 2.0 * c1 * c2 / (c1 + c2 + 1e-12)

    for i in range(n):
        for j in range(n):
            c = a[i, j]
            diag = 0.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < n and 0 <= jj < n:
                    w = face(c, a[ii, jj]) / h ** 2
                    A[idx(i, j), idx(ii, jj)] = -w
                else:
                    w = c / h ** 2  # Dirichlet ghost
                diag += w
            A[idx(i, j), idx(i, j)] = diag
    u = spsolve(A.tocsr(), b)
    return u.reshape(n, n)


def generate_darcy_files(
    root, n_train: int = 100, n_test: int = 50, resolutions=(16, 32), seed: int = 0
):
    """Write ``darcy_{train,test}_{res}.pt`` (dicts of float32 ``x``, the
    two-valued coefficient, and ``y``, the solution): the training split at
    the smallest resolution, a test split at each, all from one
    ``np.random.default_rng(seed)`` in the JAX package's order."""
    import torch

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    def make(n_samples, n):
        xs = np.empty((n_samples, n, n), dtype=np.float32)
        ys = np.empty((n_samples, n, n), dtype=np.float32)
        for s in range(n_samples):
            grf = gaussian_random_field(rng, n)
            coef = np.where(grf >= 0, 12.0, 3.0).astype(np.float32)
            xs[s] = coef
            ys[s] = solve_darcy(coef).astype(np.float32)
        return xs, ys

    base = min(resolutions)
    x, y = make(n_train, base)
    torch.save(
        {"x": torch.tensor(x), "y": torch.tensor(y)},
        (root / f"darcy_train_{base}.pt").as_posix(),
    )
    for res in resolutions:
        x, y = make(n_test, res)
        torch.save(
            {"x": torch.tensor(x), "y": torch.tensor(y)},
            (root / f"darcy_test_{res}.pt").as_posix(),
        )


__all__ = ["gaussian_random_field", "generate_darcy_files", "solve_darcy"]
