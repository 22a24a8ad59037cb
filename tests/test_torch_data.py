"""The port's TensorDataset, DataLoader, normalizer fitting and data processor
against the JAX package's.

The loaders must visit the samples in the same order for one seed, batch
for batch, so multi-step runs compare like with like. Normalizer statistics
are fitted in numpy float32 by both packages and must be equal; transforms
of the same statistics are held to ``rtol=1e-6, atol=0`` (the same f32
arithmetic).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.data.transforms import data_processors as jdp
from neuraloperator_tpu.data.transforms import normalizers as jnorm
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.data.transforms import (
    DefaultDataProcessor,
    UnitGaussianNormalizer,
    load_data_processor,
)

torch.set_num_threads(1)


def _data(seed, n=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2, 5, 4)).astype(np.float32) * 3 + 1
    y = rng.standard_normal((n, 1, 5, 4)).astype(np.float32) * 0.5 - 2
    return x, y


@pytest.mark.parametrize("shuffle,drop_last,batch_size", [
    (True, False, 3), (True, True, 3), (False, False, 4), (True, False, 11),
])
def test_loader_visits_samples_in_the_jax_order(shuffle, drop_last, batch_size):
    x, y = _data(0)
    extra = np.arange(len(x))
    port = DataLoader(TensorDataset(x, y, idx=extra), batch_size, shuffle=shuffle,
                      drop_last=drop_last, seed=7)
    ref = jds.DataLoader(jds.TensorDataset(x, y, idx=extra), batch_size, shuffle=shuffle,
                         drop_last=drop_last, seed=7)
    assert len(port) == len(ref)
    for _ in range(3):  # epochs reshuffle from one generator in both
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_loader_over_a_plain_sequence_of_samples():
    x, y = _data(1, n=5)
    samples = [{"x": x[i], "y": y[i]} for i in range(5)]
    got = list(DataLoader(samples, 2, shuffle=True, seed=3))
    want = list(jds.DataLoader(samples, 2, shuffle=True, seed=3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["x"], b["x"])


def test_tensor_dataset_items_and_checks():
    x, y = _data(2, n=4)
    ds = TensorDataset(x, y)
    assert len(ds) == 4
    np.testing.assert_array_equal(ds[2]["x"], x[2])
    with pytest.raises(ValueError):
        TensorDataset(x, y[:3])
    with pytest.raises(ValueError):
        TensorDataset(x, y, extra=np.zeros(3))


@pytest.mark.parametrize("dim", [None, [0, 2, 3], [0]])
def test_normalizer_fit_matches_jax(dim):
    x, _ = _data(3)
    port = UnitGaussianNormalizer(dim=dim).fit(x)
    ref = jnorm.UnitGaussianNormalizer(dim=dim).fit(x)
    np.testing.assert_array_equal(port.mean, ref.mean)
    np.testing.assert_array_equal(port.std, ref.std)
    assert port.n_elements == ref.n_elements
    assert port.state_dict() == ref.state_dict()
    t = torch.from_numpy(x)
    np.testing.assert_allclose(port.transform(t).numpy(),
                               np.asarray(ref.transform(jnp.asarray(x))), rtol=1e-6, atol=0)
    torch.testing.assert_close(port.inverse_transform(port.transform(t)), t)


def test_partial_fit_and_from_dataset_match_jax():
    x, y = _data(4)
    port = UnitGaussianNormalizer(dim=[0, 2, 3])
    ref = jnorm.UnitGaussianNormalizer(dim=[0, 2, 3])
    for chunk in (x[:4], x[4:9], x[9:]):
        port.partial_fit(chunk)
        ref.partial_fit(chunk)
    np.testing.assert_array_equal(port.mean, ref.mean)
    np.testing.assert_array_equal(port.std, ref.std)
    np.testing.assert_allclose(port.mean, x.mean(axis=(0, 2, 3), keepdims=True), rtol=1e-5)
    samples = [{"x": x[i], "y": y[i]} for i in range(len(x))]
    got = UnitGaussianNormalizer.from_dataset(samples, dim=[0, 2, 3])
    want = jnorm.UnitGaussianNormalizer.from_dataset(samples, dim=[0, 2, 3])
    for k in ("x", "y"):
        assert got[k].state_dict() == want[k].state_dict()


def test_refit_drops_the_statistics_cached_on_a_device():
    x, _ = _data(5)
    norm = UnitGaussianNormalizer().fit(x)
    t = torch.from_numpy(x)
    first = norm.transform(t)
    norm.fit(x * 2 + 5)
    assert not torch.allclose(norm.transform(t), first)
    with pytest.raises(RuntimeError, match="fit"):
        UnitGaussianNormalizer().transform(t)


def test_data_processor_matches_jax(tmp_path):
    x, y = _data(6)
    norms = [UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    j_norms = [jnorm.UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    port, ref = DefaultDataProcessor(*norms), jdp.DefaultDataProcessor(*j_norms)
    assert port.state_dict() == ref.state_dict()
    for train in (True, False):
        got = port.preprocess({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, train=train)
        want = ref.preprocess({"x": jnp.asarray(x), "y": jnp.asarray(y)}, train=train)
        for k in ("x", "y"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
        out, _ = port.postprocess(torch.from_numpy(y), got, train=train)
        j_out, _ = ref.postprocess(jnp.asarray(y), want, train=train)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-6, atol=0)
    # the sidecar round trip
    (tmp_path / "data_processor.json").write_text(json.dumps(port.state_dict()))
    back = load_data_processor(tmp_path)
    assert back.state_dict() == port.state_dict()
    assert back.in_normalizer.dim == [0, 2, 3] and back.in_normalizer.n_elements == 11 * 5 * 4
