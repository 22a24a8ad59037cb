"""Parity of the port's truncated-DFT transforms with the JAX package.

Tolerance: f32 ``rtol=1e-5, atol=1e-6`` (both sides sum the same f32
products in different orders).
"""

import numpy as np
import pytest
import torch

from neuraloperator_tpu.ops import fourier as jf
from neuraloperator_tpu_torch.ops import fourier as tf

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(actual, desired):
    np.testing.assert_allclose(
        np.asarray(actual), np.asarray(desired), rtol=RTOL, atol=ATOL
    )


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kept,size", [(8, 16), (7, 16), (5, 17), (20, 16), (33, 33), (0, 4)])
def test_kept_mode_counts(kept, size):
    assert tf.kept_mode_counts(kept, size) == jf.kept_mode_counts(kept, size)


@pytest.mark.parametrize("kind", ["dft_gather", "dft_scatter", "rdft_gather", "rdft_scatter"])
@pytest.mark.parametrize("n,kept", [(16, 8), (17, 7), (16, 9), (33, 17), (8, 12)])
@pytest.mark.parametrize("norm", ["forward", "backward", "ortho"])
def test_dft_matrices_match(kind, n, kept, norm):
    builder = getattr(jf, f"_{kind}_np")
    if kind == "rdft_scatter":
        kept = min(kept, n // 2 + 1)
    np.testing.assert_array_equal(
        tf._matrix(kind, n, kept, norm, torch.device("cpu")).numpy(),
        builder(n, kept, norm),
    )


@pytest.mark.parametrize("n,kept", [(16, 9), (17, 9), (33, 5), (16, 16)])
def test_rdft_gather_last(n, kept):
    x = _rand(0, 2, 3, 5, n)
    tr, ti = tf.rdft_gather_last(torch.from_numpy(x), kept, "forward")
    jr, ji = jf.rdft_gather_last(x, kept, "forward")
    _close(tr, jr)
    _close(ti, ji)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1, norm="forward")
    h = min(kept, n // 2 + 1)  # past the rfft bins the matrix aliases
    _close(tr[..., :h], ref.real[..., :h])
    _close(ti[..., :h], ref.imag[..., :h])


@pytest.mark.parametrize("axis", [-2, -3, 1])
@pytest.mark.parametrize("n,kept", [(16, 8), (17, 7), (15, 20)])
def test_dft_gather_axis(axis, n, kept):
    shape = [2, 3, 4, 5]
    shape[axis] = n
    xr, xi = _rand(1, *shape), _rand(2, *shape)
    tr, ti = tf.dft_gather_axis(torch.from_numpy(xr), torch.from_numpy(xi), kept, axis, "forward")
    jr, ji = jf.dft_gather_axis(xr, xi, kept, axis, "forward")
    assert tr.shape == jr.shape
    _close(tr, jr)
    _close(ti, ji)


@pytest.mark.parametrize("axis", [-2, -3])
@pytest.mark.parametrize("n_out,kept", [(16, 8), (17, 7), (16, 16), (9, 6)])
def test_dft_scatter_axis(axis, n_out, kept):
    shape = [2, 3, 4, 5]
    shape[axis] = kept
    xr, xi = _rand(3, *shape), _rand(4, *shape)
    tr, ti = tf.dft_scatter_axis(torch.from_numpy(xr), torch.from_numpy(xi), n_out, axis, "forward")
    jr, ji = jf.dft_scatter_axis(xr, xi, n_out, axis, "forward")
    assert tr.shape == jr.shape
    _close(tr, jr)
    _close(ti, ji)


@pytest.mark.parametrize("n_out,kept", [(16, 9), (16, 5), (17, 9), (33, 17), (32, 17)])
def test_rdft_scatter_last_hermitian(n_out, kept):
    """Including the DC column and, for even sizes, the Nyquist column."""
    cr, ci = _rand(5, 2, 3, kept), _rand(6, 2, 3, kept)
    t = tf.rdft_scatter_last(torch.from_numpy(cr), torch.from_numpy(ci), n_out, "forward")
    j = jf.rdft_scatter_last(cr, ci, n_out, "forward")
    _close(t, j)
    # independent check: irfft of the half spectrum with the imaginary
    # parts of DC (and Nyquist) dropped, as Hermitian symmetry requires
    spec = np.zeros((2, 3, n_out // 2 + 1), np.complex128)
    spec[..., :kept] = cr + 1j * ci
    spec[..., 0] = spec[..., 0].real
    if n_out % 2 == 0 and kept == n_out // 2 + 1:
        spec[..., -1] = spec[..., -1].real
    _close(t, np.fft.irfft(spec, n=n_out, axis=-1, norm="forward"))


@pytest.mark.parametrize(
    "fft_size,n_modes,max_n_modes",
    [
        ((16, 9), (8, 5), (8, 5)),
        ((16, 9), (6, 3), (9, 4)),  # odd start: extra entry off the end
        ((16, 9), (6, 3), (11, 7)),
        ((4, 3), (8, 5), (8, 5)),  # modes beyond the spectrum
    ],
)
def test_resolve_weight_slices(fft_size, n_modes, max_n_modes):
    for separable in (False, True):
        assert tf.resolve_weight_slices(
            fft_size, n_modes, max_n_modes, separable, False
        ) == jf.resolve_weight_slices(fft_size, n_modes, max_n_modes, separable, False)
    for start in range(7):
        assert tf._center_slice(start) == jf._center_slice(start)
    assert tf._center_slice(3) == slice(1, -2)
