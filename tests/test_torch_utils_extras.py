"""The public names of the JAX package's ``utils.py``, normalizers, tensor
datasets and ``ops/fourier.py`` that the port took last, each held to its
JAX function on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu import utils as jutils
from neuraloperator_tpu.data.datasets import GeneralTensorDataset as JGeneralTensorDataset
from neuraloperator_tpu.data.transforms import DictUnitGaussianNormalizer as JDictNormalizer
from neuraloperator_tpu.data.transforms import UnitGaussianNormalizer as JNormalizer
from neuraloperator_tpu.ops import fourier as jfourier
from neuraloperator_tpu_torch import utils
from neuraloperator_tpu_torch.data.datasets import GeneralTensorDataset
from neuraloperator_tpu_torch.data.transforms import (
    DictUnitGaussianNormalizer,
    UnitGaussianNormalizer,
)
from neuraloperator_tpu_torch.ops import fourier

torch.set_num_threads(1)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dims", [None, [0], [1, 2]])
@pytest.mark.parametrize("complex_", [False, True])
def test_count_tensor_params_matches_jax(dims, complex_):
    a = _rand(0, 3, 4, 5)
    if complex_:
        a = a + 1j * _rand(1, 3, 4, 5)
    want = jutils.count_tensor_params(jnp.asarray(a), dims)
    assert utils.count_tensor_params(torch.from_numpy(a), dims) == want
    assert utils.count_tensor_params(a, dims) == want


def test_spectrum_2d_matches_jax():
    signal = _rand(2, 3, 16, 16)
    want = np.asarray(jutils.spectrum_2d(jnp.asarray(signal), 16))
    got = utils.spectrum_2d(torch.from_numpy(signal), 16)
    assert got.dtype == torch.float64 and got.shape == want.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # normalize=False takes the (16, 9) rfft2, which the (16, 16) ring masks
    # do not index: both raise
    with pytest.raises(IndexError):
        jutils.spectrum_2d(jnp.asarray(signal), 16, normalize=False)
    with pytest.raises(IndexError):
        utils.spectrum_2d(torch.from_numpy(signal), 16, normalize=False)


def test_ranks_match_jax():
    low = _rand(3, 6, 2) @ _rand(4, 2, 5)  # rank 2
    for a in (low, _rand(5, 4, 3, 2)):
        flat = a.reshape(a.shape[0], -1)
        assert int(utils.compute_rank(torch.from_numpy(flat))) == int(
            jutils.compute_rank(jnp.asarray(flat)))
        np.testing.assert_allclose(float(utils.compute_stable_rank(torch.from_numpy(a))),
                                   float(jutils.compute_stable_rank(jnp.asarray(a))), rtol=1e-5)


def test_project_root_is_the_repository():
    assert utils.get_project_root() == jutils.get_project_root()
    assert (utils.get_project_root() / "neuraloperator_tpu_torch" / "utils.py").exists()


def test_count_flops_of_an_fno_forward_against_the_analytic_count():
    """FlopCounterMode counts the matmuls of the truncated DFTs and the
    channel MLPs and the contraction operator's registered 8·B·I·O·M; the
    analytic ``flops_per_fno_step`` counts full FFTs at 5·N·log2 N instead
    of the truncated DFT matmuls. At 16² with 8 x 8 modes the two counts
    agree within 35%; the contraction alone, counted from its operator,
    equals the formula's share to the flop."""
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
    from neuraloperator_tpu_torch.training.profiling import flops_per_fno_step

    torch.manual_seed(0)
    model = FNO(n_modes=(8, 8), in_channels=1, out_channels=1, hidden_channels=16,
                n_layers=2, device="cpu")
    x = torch.randn(4, 1, 16, 16)
    with torch.no_grad():
        counted = utils.count_flops(model, x)
    assert set(counted) == {"flops", "bytes_accessed"}
    analytic = flops_per_fno_step(4, 16, (8, 8), 16, 2, training=False)
    assert 0.65 * analytic <= counted["flops"] <= 1.35 * analytic, (counted, analytic)
    xr = torch.randn(4, 16, 40)
    wr = torch.randn(16, 16, 40)
    contraction = utils.count_flops(tsc.mode_contraction, xr, xr, wr, wr)["flops"]
    assert contraction == 8 * 4 * 16 * 16 * 40


def test_dict_normalizer_matches_jax():
    data = {"x": _rand(6, 4, 2, 8), "y": _rand(7, 4, 1, 8), "t": _rand(8, 4)}
    norms = {k: UnitGaussianNormalizer(dim=[0, 2]).fit(data[k]) for k in ("x", "y")}
    jnorms = {k: JNormalizer(dim=[0, 2]).fit(jnp.asarray(data[k])) for k in ("x", "y")}
    ours, ref = DictUnitGaussianNormalizer(norms), JDictNormalizer(jnorms)
    got = ours.transform({k: torch.from_numpy(v) for k, v in data.items()})
    want = ref.transform({k: jnp.asarray(v) for k, v in data.items()})
    for k in data:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    back = ours.inverse_transform(got)
    for k in data:
        np.testing.assert_allclose(back[k].numpy(), data[k], rtol=1e-5, atol=1e-6)


def test_general_tensor_dataset_matches_jax():
    a, b = _rand(9, 5, 3), _rand(10, 5, 2)
    double = lambda v: 2 * v  # noqa: E731
    ours = GeneralTensorDataset([a, b], [double, None])
    ref = JGeneralTensorDataset([a, b], [double, None])
    assert len(ours) == len(ref) == 5
    for i in (0, 4):
        for got, want in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(got, want)
    one = GeneralTensorDataset([a], [None])
    np.testing.assert_array_equal(one[2], JGeneralTensorDataset([a], [None])[2])
    with pytest.raises(ValueError, match="number of tensors and transforms"):
        GeneralTensorDataset([a, b], [None])
    with pytest.raises(ValueError, match="between tensors"):
        GeneralTensorDataset([a, b[:3]], [None, None])


# (leading shape, out_sizes, axes): 1-D to 3-D, even and odd last sizes, the
# last axis full (n // 2 + 1 bins) and shorter
HERMITIAN_CASES = [
    ((2, 3, 9), (16,), (-1,)),
    ((2, 3, 8, 9), (8, 16), (-2, -1)),
    ((2, 8, 5), (8, 9), (-2, -1)),
    ((1, 6, 4, 5), (6, 4, 8), (-3, -2, -1)),
    ((2, 8, 6), (8, 16), (-2, -1)),
]


@pytest.mark.parametrize("shape,out_sizes,axes", HERMITIAN_CASES)
@pytest.mark.parametrize("enforce", [True, False])
def test_irfft_hermitian_matches_jax(shape, out_sizes, axes, enforce):
    spec = _rand(11, *shape) + 1j * _rand(12, *shape)
    want = np.asarray(jfourier.irfft_hermitian(jnp.asarray(spec, jnp.complex64), out_sizes,
                                               axes, "forward", enforce))
    got = fourier.irfft_hermitian(torch.from_numpy(spec.astype(np.complex64)), out_sizes, axes,
                                  "forward", enforce)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("shape,out_sizes,axes", HERMITIAN_CASES)
def test_hermitianize_parts_matches_jax(shape, out_sizes, axes):
    re, im = _rand(13, *shape), _rand(14, *shape)
    want = jfourier.hermitianize_parts(jnp.asarray(re), jnp.asarray(im), out_sizes, axes)
    got = fourier.hermitianize_parts(torch.from_numpy(re), torch.from_numpy(im), out_sizes,
                                     axes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
