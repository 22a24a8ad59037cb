"""Host-side synthetic PDE data (port of
``neuraloperator_tpu/data/datasets/synthetic.py``): the Darcy generator
(``gaussian_random_field``, ``solve_darcy``, ``generate_darcy_files``) and
the Burgers ones (``solve_burgers_1d``, ``generate_burgers_files``,
``solve_burgers_trajectory``, ``generate_burgers_spacetime_files``),
unchanged numpy and scipy, so one seed writes the same arrays to the bit in
both packages."""

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


def solve_burgers_1d(
    u0: np.ndarray, visc: float = 0.01, T: float = 1.0, steps: int = 200
) -> np.ndarray:
    """Pseudo-spectral 1-D viscous Burgers solver (RK4, periodic)."""
    n = u0.shape[-1]
    k = 2 * np.pi * np.fft.fftfreq(n, d=1.0 / n)
    dt = T / steps

    def rhs(u):
        uh = np.fft.fft(u)
        ux = np.real(np.fft.ifft(1j * k * uh))
        uxx = np.real(np.fft.ifft(-(k ** 2) * uh))
        return -u * ux + visc * uxx

    u = u0.copy()
    for _ in range(steps):
        k1 = rhs(u)
        k2 = rhs(u + 0.5 * dt * k1)
        k3 = rhs(u + 0.5 * dt * k2)
        k4 = rhs(u + dt * k3)
        u = u + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return u


def generate_burgers_files(root, n_train=100, n_test=50, res=16, seed=0):
    """Write ``burgers_{train,test}_{res}.pt`` (dicts of float32 ``x``, the
    initial condition, and ``y``, the solution at T=1, visc 0.01).

    The draws are the JAX package's, from one ``np.random.default_rng(seed)``
    in its order. Its solver does not resolve the shock of some draws on a
    coarse grid and returns non-finite values there (11 of the first 150
    at res 16, whatever the time step); each such pair is replaced, after
    both splits are drawn, by the next draw of the same generator whose
    solution is finite. Every pair the JAX package solves to a finite value
    is written at its place, equal to the bit.
    """
    import torch

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    grid = np.linspace(0, 2 * np.pi, res, endpoint=False)

    def draw():
        coef = rng.standard_normal(5) / np.arange(1, 6)
        u0 = sum(c * np.sin((i + 1) * grid) for i, c in enumerate(coef)).astype(np.float32)
        with np.errstate(over="ignore", invalid="ignore"):
            return u0, solve_burgers_1d(u0).astype(np.float32)

    splits = {}
    for split, n_samples in (("train", n_train), ("test", n_test)):
        xs = np.empty((n_samples, res), dtype=np.float32)
        ys = np.empty((n_samples, res), dtype=np.float32)
        for s in range(n_samples):
            xs[s], ys[s] = draw()
        splits[split] = (xs, ys)
    for xs, ys in splits.values():
        for s in np.flatnonzero(~np.isfinite(ys).all(axis=1)):
            xs[s], ys[s] = draw()
            while not np.isfinite(ys[s]).all():
                xs[s], ys[s] = draw()
    for split, (x, y) in splits.items():
        torch.save(
            {"x": torch.tensor(x), "y": torch.tensor(y)},
            (root / f"burgers_{split}_{res}.pt").as_posix(),
        )


def solve_burgers_trajectory(u0, visc=0.05, T=1.0, nt=16, steps_per_frame=100):
    """Record the full (nt, nx) Burgers trajectory including t=0."""
    frames = [u0.copy()]
    u = u0.copy()
    dt_frame = T / (nt - 1)
    for _ in range(nt - 1):
        u = solve_burgers_1d(u, visc=visc, T=dt_frame, steps=steps_per_frame)
        frames.append(u.copy())
    return np.stack(frames)


def generate_burgers_spacetime_files(root, n_train=64, n_test=16, res=16,
                                     nt=16, visc=0.05, seed=0):
    """Write burgers_pino_{split}_{res}.pt files: u0 field -> (nt, nx)
    space-time solution (for physics-informed training)."""
    import torch

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    grid = np.linspace(0, 2 * np.pi, res, endpoint=False)

    def make(n_samples):
        xs = np.empty((n_samples, nt, res), dtype=np.float32)
        ys = np.empty((n_samples, nt, res), dtype=np.float32)
        for s in range(n_samples):
            coef = rng.standard_normal(4) / np.arange(1, 5)
            u0 = sum(c * np.sin((i + 1) * grid) for i, c in enumerate(coef))
            traj = solve_burgers_trajectory(
                u0.astype(np.float64), visc=visc, nt=nt
            )
            xs[s] = np.broadcast_to(u0, (nt, res)).astype(np.float32)
            ys[s] = traj.astype(np.float32)
        return xs, ys

    for split, n_samples in (("train", n_train), ("test", n_test)):
        x, y = make(n_samples)
        torch.save(
            {"x": torch.tensor(x), "y": torch.tensor(y)},
            (root / f"burgers_pino_{split}_{res}.pt").as_posix(),
        )


__all__ = ["gaussian_random_field", "generate_burgers_files", "generate_burgers_spacetime_files",
           "generate_darcy_files", "solve_burgers_1d", "solve_burgers_trajectory", "solve_darcy"]
