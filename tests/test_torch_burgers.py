"""The port's Burgers data against the JAX package's.

The generators are numpy in both packages: the trajectories and the
space-time files are equal to the bit. The 1-D pairs are equal to the bit
wherever the JAX solver returns finite values; where it does not (an
under-resolved shock: 4 of the first 30 draws at 16 points), the port
writes a later draw of the same generator whose solution is finite
(ROADMAP §C). The tracked ``burgers_pino_*_16.pt`` of the JAX package were
written by another numpy: their inputs are equal to the bit, their
solutions within 1e-6 relative (a probe read 2.0e-7) of what both
generators write today. Nothing is written into the JAX package: the JAX
loader is pointed at a temporary directory.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import burgers as jburgers
from neuraloperator_tpu.data.datasets import synthetic as jsyn
from neuraloperator_tpu_torch.data.datasets import burgers as tburgers
from neuraloperator_tpu_torch.data.datasets import load_burgers_1d, load_mini_burgers_1dtime
from neuraloperator_tpu_torch.data.datasets import synthetic as tsyn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRACKED = ROOT / "neuraloperator_tpu/data/datasets/data"
TRACKED_REL_TOL = 1e-6


def _load(path):
    data = torch.load(Path(path).as_posix(), weights_only=True)
    return data["x"].numpy(), data["y"].numpy()


def test_burgers_pairs_equal_jax_where_its_solver_is_finite(tmp_path):
    jsyn.generate_burgers_files(tmp_path / "jax", n_train=20, n_test=10, res=16)
    tsyn.generate_burgers_files(tmp_path / "port", n_train=20, n_test=10, res=16)
    replaced = 0
    for split in ("train", "test"):
        jx, jy = _load(tmp_path / f"jax/burgers_{split}_16.pt")
        tx, ty = _load(tmp_path / f"port/burgers_{split}_16.pt")
        finite = np.isfinite(jy).all(axis=1)
        assert np.array_equal(tx[finite], jx[finite]) and np.array_equal(ty[finite], jy[finite])
        assert np.isfinite(ty).all() and np.isfinite(tx).all()
        assert not np.array_equal(tx[~finite], jx[~finite]) or finite.all()
        replaced += int((~finite).sum())
    assert replaced == 4


def test_solve_burgers_equals_jax():
    rng = np.random.default_rng(3)
    grid = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    u0 = sum(c * np.sin((k + 1) * grid) for k, c in enumerate(rng.standard_normal(4) / 2))
    got = tsyn.solve_burgers_1d(u0, visc=0.05, steps=400)
    assert np.isfinite(got).all()
    assert np.array_equal(got, jsyn.solve_burgers_1d(u0, visc=0.05, steps=400))
    want = jsyn.solve_burgers_trajectory(u0, visc=0.05, nt=5, steps_per_frame=100)
    got = tsyn.solve_burgers_trajectory(u0, visc=0.05, nt=5, steps_per_frame=100)
    assert got.shape == (5, 32) and np.array_equal(got, want)


def test_spacetime_files_equal_jax_and_the_tracked_files(tmp_path):
    jsyn.generate_burgers_spacetime_files(tmp_path / "jax", n_train=32, n_test=8, res=16)
    tsyn.generate_burgers_spacetime_files(tmp_path / "port", n_train=32, n_test=8, res=16)
    for split in ("train", "test"):
        jx, jy = _load(tmp_path / f"jax/burgers_pino_{split}_16.pt")
        tx, ty = _load(tmp_path / f"port/burgers_pino_{split}_16.pt")
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
        kx, ky = _load(TRACKED / f"burgers_pino_{split}_16.pt")
        assert kx.shape == tx.shape and np.array_equal(tx, kx)
        assert np.linalg.norm(ty - ky) / np.linalg.norm(ky) <= TRACKED_REL_TOL


def test_load_burgers_1d_default_root_is_the_ports_own(tmp_path, monkeypatch):
    assert tburgers.DATA_ROOT == ROOT / "neuraloperator_tpu_torch/data/datasets/data"
    monkeypatch.setattr(tburgers, "DATA_ROOT", tmp_path)
    train, tests, processor = load_burgers_1d(n_train=8, n_tests=[6], batch_size=4,
                                              test_batch_sizes=[3])
    # the JAX loader's counts when it generates: 100 training and 50 test pairs
    assert _load(tmp_path / "burgers_train_16.pt")[0].shape == (100, 16)
    assert _load(tmp_path / "burgers_test_16.pt")[0].shape == (50, 16)
    monkeypatch.setattr(jburgers, "_CANDIDATE_ROOTS", [tmp_path])
    jtrain, jtests, jprocessor = jburgers.load_burgers_1d(n_train=8, n_tests=[6], batch_size=4,
                                                         test_batch_sizes=[3])
    assert len(train) == len(jtrain) == 2 and list(tests) == list(jtests) == [16]
    for _ in range(2):  # two epochs of the seeded shuffle
        for got, want in zip(train, jtrain):
            assert got["x"].shape == (4, 1, 16)
            assert np.array_equal(got["x"], want["x"]) and np.array_equal(got["y"], want["y"])
    for got, want in zip(tests[16], jtests[16]):
        assert np.array_equal(got["y"], want["y"])
    norm, jnorm = processor.out_normalizer, jprocessor.out_normalizer
    assert np.allclose(norm.mean, np.asarray(jnorm.mean), rtol=0, atol=1e-7)
    assert np.allclose(norm.std, np.asarray(jnorm.std), rtol=1e-6)
    # the alias reads the same files
    alias, _, _ = load_mini_burgers_1dtime(n_train=8, n_tests=[6], batch_size=4,
                                           test_batch_sizes=[3])
    assert np.array_equal(alias.dataset.arrays["x"], train.dataset.arrays["x"])


def test_load_burgers_1d_reads_an_explicit_root(tmp_path, monkeypatch):
    tsyn.generate_burgers_files(tmp_path, n_train=12, n_test=6, res=16)
    monkeypatch.setattr(tburgers, "DATA_ROOT", tmp_path / "unused")
    train, tests, _ = load_burgers_1d(n_train=12, n_tests=[6], batch_size=4,
                                      test_batch_sizes=[6], data_root=str(tmp_path))
    assert not (tmp_path / "unused").exists()
    assert len(train) == 3 and len(tests[16]) == 1
    with pytest.raises(FileNotFoundError):
        load_burgers_1d(n_train=4, n_tests=[4], batch_size=4, test_batch_sizes=[4],
                        data_root=str(tmp_path / "missing"))
