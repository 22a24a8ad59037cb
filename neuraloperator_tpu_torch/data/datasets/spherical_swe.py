"""Spherical shallow-water data for the SFNO (port of
``neuraloperator_tpu/data/datasets/spherical_swe.py``).

Random band-limited initial states on the sphere, advanced by a spectral
step built on the port's SHT (``ops/sht.py``): per-degree rotation phases
and mild diffusion. The pairs are (u(t0), u(t1)) of a 3-channel state.

This is host data preparation, as ``synthetic.py`` is: the states are made
on the CPU in float32 (the JAX module pins its generation to the CPU
backend), whatever device trains on them. The draws and dtypes follow the
JAX module's: one ``numpy`` generator, complex128 coefficients cast to
complex64 for the inverse SHT, the SHT's complex64 result multiplied by a
complex128 phase and damping, cast back to complex64.
"""

from typing import Tuple

import numpy as np
import torch

from ...ops.sht import isht, sht


class SphericalSWESolver:
    """Coarse spectral dynamics on the sphere: the state advanced in
    spectral space with rotation-dependent phase speeds and diffusion."""

    def __init__(self, nlat: int = 32, nlon: int = 64, lmax: int = None,
                 diffusion: float = 1e-4, rotation: float = 1.0):
        self.nlat = nlat
        self.nlon = nlon
        self.lmax = lmax or nlat // 2
        self.diffusion = diffusion
        self.rotation = rotation

    def random_state(self, rng: np.random.Generator) -> np.ndarray:
        """A random smooth 3-channel field on the sphere, (3, nlat, nlon) f32."""
        lmax = self.lmax
        coeffs = rng.standard_normal((3, lmax, lmax)) + 1j * rng.standard_normal((3, lmax, lmax))
        l = np.arange(lmax)[:, None]
        coeffs = coeffs * (1.0 + l) ** -2.5
        coeffs = coeffs * np.tril(np.ones((lmax, lmax)))  # m <= l
        with torch.no_grad():
            field = isht(torch.from_numpy(coeffs.astype(np.complex64)), nlat=self.nlat,
                         nlon=self.nlon, grid="equiangular")
        return field.numpy().astype(np.float32)

    def step(self, state: np.ndarray, dt: float = 0.1, n_steps: int = 10) -> np.ndarray:
        """Advance the state: per-degree rotation phases and diffusion."""
        with torch.no_grad():
            flm = sht(torch.from_numpy(np.ascontiguousarray(state, np.float32)),
                      lmax=self.lmax, mmax=self.lmax, grid="equiangular").numpy()
        l = np.arange(self.lmax)[:, None]
        m = np.arange(self.lmax)[None, :]
        # Rossby-Haurwitz-like dispersion: omega = -2 Omega m / (l (l + 1))
        ll = np.where(l == 0, 1, l * (l + 1))
        omega = -2.0 * self.rotation * m / ll
        damp = np.exp(-self.diffusion * (l * (l + 1)) * dt * n_steps)
        phase = np.exp(1j * omega * dt * n_steps)
        flm = flm * (phase * damp)[None]
        with torch.no_grad():
            out = isht(torch.from_numpy(flm.astype(np.complex64)), nlat=self.nlat,
                       nlon=self.nlon, grid="equiangular")
        return out.numpy().astype(np.float32)


def load_spherical_swe(
    n_train: int = 32,
    n_test: int = 8,
    batch_size: int = 4,
    test_batch_sizes=(4,),
    train_resolution: Tuple[int, int] = (32, 64),
    test_resolutions=((32, 64),),
    seed: int = 0,
):
    """Train and test loaders of SWE pairs made on the host.

    Returns (train_loader, test_loaders keyed by resolution tuple, None);
    batches are ``{'x': (b, 3, nlat, nlon), 'y': same}``. One generator
    draws the training split, then each test resolution in order.
    """
    from .tensor_dataset import DataLoader, TensorDataset

    rng = np.random.default_rng(seed)

    def make(n, res):
        solver = SphericalSWESolver(nlat=res[0], nlon=res[1])
        xs, ys = [], []
        for _ in range(n):
            x0 = solver.random_state(rng)
            xs.append(x0)
            ys.append(solver.step(x0))
        return TensorDataset(np.stack(xs), np.stack(ys))

    train_loader = DataLoader(make(n_train, train_resolution), batch_size, shuffle=True,
                              seed=seed)
    test_loaders = {
        tuple(res): DataLoader(make(n_test, res), bs)
        for res, bs in zip(test_resolutions, test_batch_sizes)
    }
    return train_loader, test_loaders, None


class SphericalSWEDataset:
    """Map-style SWE dataset: item i is ``{'x': (3, nlat, nlon), 'y': same}``,
    a random state and the state ``dt`` later, drawn from a per-item seed.
    Only ``initial_condition="random"``, as in the JAX package."""

    def __init__(self, dt: float = 3600, dims: Tuple[int, int] = (32, 64),
                 initial_condition: str = "random", num_examples: int = 32,
                 normalize: bool = True, seed: int = 0):
        if initial_condition != "random":
            raise ValueError(
                f"initial_condition must be 'random' (got {initial_condition!r}); "
                "Galewsky-style initial conditions are not implemented"
            )
        # finer grids need a smaller solver step
        dt_min = 256 / dims[0] * 150
        self.nsteps = max(int(dt // dt_min), 1)
        self.num_examples = num_examples
        self.normalize = normalize
        self.initial_condition = initial_condition
        self.seed = seed
        self.solver = SphericalSWESolver(nlat=dims[0], nlon=dims[1])

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + index)
        x = self.solver.random_state(rng)
        y = self.solver.step(x, n_steps=self.nsteps)
        if self.normalize:
            mean = x.mean(axis=(-2, -1), keepdims=True)
            std = x.std(axis=(-2, -1), keepdims=True) + 1e-8
            x = (x - mean) / std
            y = (y - mean) / std
        return {"x": x.astype(np.float32), "y": y.astype(np.float32)}


__all__ = ["SphericalSWEDataset", "SphericalSWESolver", "load_spherical_swe"]
