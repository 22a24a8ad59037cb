"""The port's spherical harmonic transforms against the JAX package.

``ops/sht.py`` of both packages on the same numpy fields, on the
"equiangular" and "legendre-gauss" grids, at small sizes: the Legendre
matrices (built in float64 numpy by copies of one recurrence) to the bit,
``sht`` and ``isht`` within relative l2 2e-6 (each part of the complex
coefficients apart), including a longitude too short for the orders asked
(``m_avail < mmax``: zero-padded) and coefficients with more orders than
the inverse's longitude holds (``m > nlon//2 + 1``: dropped). A CPU probe
read 1.5e-7 at most (the same f32 matmuls, summed in another order; JAX's
own jitted and eager SHT agree to the bit), so 2e-6 leaves a factor of ten.

A band-limited field survives ``isht`` then ``sht``: on the Gauss grid
for degrees below ``nlat``, on the equiangular grid (Fejér weights) for
degrees below ``nlat / 2``, the coefficients within 1e-5 relative l2 of
the ones synthesised (f32 round trip; 1.2e-7 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.ops import sht as jsht
from neuraloperator_tpu_torch.ops import sht as tsht

torch.set_num_threads(1)

TOL = 2e-6
ROUND_TRIP_TOL = 1e-5
GRIDS = ("equiangular", "legendre-gauss")
# (nlat, nlon, lmax, mmax): the ordinary case, m_avail < mmax (6 // 2 + 1 =
# 4 < 5, padded on the way in and cut on the way back), square, and more
# orders than degrees
SHAPES = [(8, 16, 6, 5), (8, 6, 6, 5), (12, 24, 12, 12), (16, 32, 8, 16)]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return max(float(np.linalg.norm(part(a - b)) / np.linalg.norm(part(b)))
               for part in (np.real, np.imag) if np.linalg.norm(part(b)) > 0)


@pytest.mark.parametrize("grid", GRIDS)
def test_legendre_matrices_are_the_jax_ones(grid):
    for nlat, _, lmax, mmax in SHAPES:
        ja, js = jsht._sht_matrices_np(nlat, lmax, mmax, grid)
        ta, ts = tsht._sht_matrices_np(nlat, lmax, mmax, grid)
        assert ta.dtype == np.float32 and np.array_equal(ta, ja) and np.array_equal(ts, js)
    with pytest.raises(ValueError, match="unknown grid"):
        tsht._quadrature(8, "healpix")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sht_and_isht_match_jax(grid, shape):
    nlat, nlon, lmax, mmax = shape
    x = _rand(nlat + nlon, 2, 3, nlat, nlon)
    expected = np.asarray(jsht.sht(jnp.asarray(x), lmax, mmax, grid))
    got = tsht.sht(torch.from_numpy(x), lmax, mmax, grid)
    assert got.shape == (2, 3, lmax, mmax) and got.dtype == torch.complex64
    assert _rel_l2(got.numpy(), expected) <= TOL

    flm = (_rand(1, 2, 3, lmax, mmax) + 1j * _rand(2, 2, 3, lmax, mmax)).astype(np.complex64)
    expected = np.asarray(jsht.isht(jnp.asarray(flm), nlat, nlon, grid))
    got = tsht.isht(torch.from_numpy(flm), nlat, nlon, grid)
    assert got.shape == (2, 3, nlat, nlon) and got.dtype == torch.float32
    assert _rel_l2(got.numpy(), expected) <= TOL
    # a (re, im) pair is the same coefficients
    pair = (torch.from_numpy(flm.real.copy()), torch.from_numpy(flm.imag.copy()))
    assert torch.equal(tsht.isht(pair, nlat, nlon, grid), got)


@pytest.mark.parametrize("grid", GRIDS)
def test_a_band_limited_field_survives_the_round_trip(grid):
    nlat, nlon = 16, 32
    lmax = nlat if grid == "legendre-gauss" else nlat // 2
    flm = _rand(3, 2, lmax, lmax) + 1j * _rand(4, 2, lmax, lmax)
    flm = flm * np.tril(np.ones((lmax, lmax)))  # m <= l
    flm[..., 0] = flm[..., 0].real  # a real field's m = 0 coefficients are real
    field = tsht.isht(torch.from_numpy(flm.astype(np.complex64)), nlat, nlon, grid)
    back = tsht.sht(field, lmax, lmax, grid).numpy()
    assert _rel_l2(back, flm) <= ROUND_TRIP_TOL


def test_sht_gradients_match_jax():
    """The transforms' gradients: the transposed matmuls, within the forward's bound."""
    nlat, nlon, lmax, mmax = 8, 16, 6, 5
    x = _rand(5, 1, 2, nlat, nlon)
    gr, gi = _rand(6, 1, 2, lmax, mmax), _rand(7, 1, 2, lmax, mmax)

    def jloss(x):
        f = jsht.isht(jsht.sht(x, lmax, mmax) * (gr + 1j * gi), nlat, 2 * nlon)
        return jnp.sum(f * jnp.asarray(_rand(8, 1, 2, nlat, 2 * nlon)))

    expected = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    f = tsht.isht(tsht.sht(xt, lmax, mmax) * torch.complex(torch.from_numpy(gr),
                                                           torch.from_numpy(gi)),
                  nlat, 2 * nlon)
    (f * torch.from_numpy(_rand(8, 1, 2, nlat, 2 * nlon))).sum().backward()
    assert _rel_l2(xt.grad.numpy(), expected) <= TOL


def test_only_the_orthonormal_norm():
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="ortho"):
        tsht.sht(x, 4, 4, norm="forward")
    with pytest.raises(ValueError, match="ortho"):
        tsht.isht(torch.zeros(1, 4, 4, dtype=torch.complex64), 8, 16, norm="backward")
