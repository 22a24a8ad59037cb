"""Synthetic car-CFD-style dataset: smooth 3-D bodies and their surface
pressure (port of ``neuraloperator_tpu/data/datasets/synthetic_cfd.py``;
the same numpy, so one seed gives the same arrays to the bit).

The samples have the mesh schema of the car-CFD set (vertices,
vertex_normals, press, query_points, distance, closest_points):

- **Geometry**: deformed ellipsoids. Unit directions from a Fibonacci
  sphere; radius field rho(u) = 1 + sum_k c_k B_k(u) over low-order
  harmonic polynomials (smooth, random per sample); anisotropic scaling
  (elongated x, car-like).
- **Normals**: central differences of the body's implicit function
  G(p) = |S^-1 p| - rho(dir(S^-1 p)).
- **Pressure**: a potential-flow proxy, cp = 1 - 9/4 sin^2(theta) with theta
  the angle between the surface normal and the freestream, modulated by
  the local radius.
- **SDF grid**: signed min-distance from a padded bounding-box grid to the
  vertex cloud (sign from G), plus the closest surface point.

Everything is float64 numpy on the host, stored as float32.
"""

import math
from typing import List

import numpy as np

_FREESTREAM = np.array([1.0, 0.0, 0.0], np.float64)

# smooth low-order harmonic polynomial basis on the unit sphere
_BASIS = [
    lambda u: u[..., 0],
    lambda u: u[..., 1],
    lambda u: u[..., 2],
    lambda u: u[..., 0] * u[..., 1],
    lambda u: u[..., 0] * u[..., 2],
    lambda u: u[..., 1] * u[..., 2],
    lambda u: u[..., 0] ** 2 - u[..., 1] ** 2,
    lambda u: 3.0 * u[..., 2] ** 2 - 1.0,
    lambda u: u[..., 0] * (u[..., 0] ** 2 - 3 * u[..., 1] ** 2),
    lambda u: u[..., 2] * (5.0 * u[..., 2] ** 2 - 3.0),
]


def _fibonacci_sphere(n: int) -> np.ndarray:
    """n near-uniform unit directions."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = math.pi * (3.0 - math.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.clip(1.0 - z * z, 0.0, None))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def _rho(u: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Radius field on unit directions."""
    out = np.ones(u.shape[:-1])
    for c, b in zip(coeffs, _BASIS):
        out = out + c * b(u)
    return np.clip(out, 0.35, None)


def _implicit(p: np.ndarray, inv_scale: np.ndarray, coeffs: np.ndarray):
    """G(p) < 0 inside, = 0 on the surface."""
    q = p * inv_scale
    r = np.linalg.norm(q, axis=-1)
    u = q / np.clip(r[..., None], 1e-12, None)
    return r - _rho(u, coeffs)


def _normals(p, inv_scale, coeffs, h=1e-4):
    g = np.zeros_like(p)
    for a in range(3):
        dp = np.zeros(3)
        dp[a] = h
        g[..., a] = (
            _implicit(p + dp, inv_scale, coeffs)
            - _implicit(p - dp, inv_scale, coeffs)
        ) / (2 * h)
    return g / np.clip(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12, None)


def generate_cfd_sample(
    rng: np.random.Generator,
    n_verts: int = 2048,
    grid_n: int = 16,
    deform: float = 0.08,
) -> dict:
    u = _fibonacci_sphere(n_verts)
    coeffs = rng.normal(0.0, deform, len(_BASIS))
    scale = np.array(
        [rng.uniform(1.6, 2.2), rng.uniform(0.7, 1.0), rng.uniform(0.6, 0.9)]
    )
    inv_scale = 1.0 / scale
    verts = (_rho(u, coeffs)[..., None] * u) * scale
    normals = _normals(verts, inv_scale, coeffs)

    # potential-flow proxy pressure: cp = 1 - 9/4 sin^2(theta_n), modulated
    # by local radius (relative to mean) so the field depends on the full
    # geometry, not the normal alone
    cos_t = normals @ _FREESTREAM
    sin2 = 1.0 - cos_t**2
    local_r = np.linalg.norm(verts, axis=-1)
    mod = local_r / local_r.mean()
    press = (1.0 - 2.25 * sin2 * mod).astype(np.float32)

    # padded bounding-box query grid + signed distance + closest points
    lo = verts.min(0) - 0.15
    hi = verts.max(0) + 0.15
    axes = [np.linspace(lo[a], hi[a], grid_n) for a in range(3)]
    qp = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    flat = qp.reshape(-1, 3)
    d2 = ((flat[:, None, :] - verts[None, :, :]) ** 2).sum(-1)
    nearest = d2.argmin(1)
    dist = np.sqrt(d2[np.arange(len(flat)), nearest])
    sign = np.sign(_implicit(flat, inv_scale, coeffs))
    sdf = (sign * dist).reshape(grid_n, grid_n, grid_n, 1)
    closest = verts[nearest].reshape(grid_n, grid_n, grid_n, 3)

    return {
        "vertices": verts.astype(np.float32),
        "vertex_normals": normals.astype(np.float32),
        "press": press[None].astype(np.float32),  # (1, n_verts)
        "query_points": qp.astype(np.float32),
        "distance": sdf.astype(np.float32),
        "closest_points": closest.astype(np.float32),
    }


def load_synthetic_cfd(
    n_samples: int,
    n_verts: int = 2048,
    grid_n: int = 16,
    seed: int = 0,
) -> List[dict]:
    """Generate ``n_samples`` synthetic car-CFD-style samples from a
    generator seeded with ``seed``, in the schema of ``load_mini_car``."""
    rng = np.random.default_rng(seed)
    return [
        generate_cfd_sample(rng, n_verts=n_verts, grid_n=grid_n)
        for _ in range(n_samples)
    ]
