"""The port's Navier–Stokes data path against the JAX package's, on the CPU.

Covered: ``navier_stokes.solve_navier_stokes_2d`` (the loader's fallback
solver, float64 in both packages), ``generate_navier_stokes_files``, the
``generate_ns_data`` entry point (the flagship's solver), ``PTDataset``,
``load_navier_stokes_pt`` and ``NavierStokesDataset``.

Tolerances: the fallback solver at 16², relative l2 1e-5 (both run float64,
numpy's pocketfft and torch's). Generated files:
inputs equal exactly (the same numpy draws), targets within relative l2
1e-5 (the float64 solve, rounded to float32; the flagship solver's
trajectories within 1e-5 per snapshot, as ``tests/test_torch_ns_solver.py``
holds them: float32 steps whose FFTs round differently). Loaders over the
same files: batches equal exactly, normalizer statistics within
``rtol=1e-6`` (both fit in numpy float32).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import navier_stokes as jns
from neuraloperator_tpu.data.datasets import pt_dataset as jpt
from neuraloperator_tpu_torch.data.datasets import load_pt_as_numpy
from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
from neuraloperator_tpu_torch.data.datasets import pt_dataset as tpt
from neuraloperator_tpu_torch.scripts import generate_ns_data

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("record_steps", [1, 4])
def test_fallback_solver_matches_jax(record_steps):
    from neuraloperator_tpu.data.datasets.synthetic import gaussian_random_field

    rng = np.random.default_rng(3)
    w0 = np.stack([gaussian_random_field(rng, 16, alpha=2.5, tau=7.0) * 5 for _ in range(3)])
    port = tns.solve_navier_stokes_2d(w0, T=0.5, delta_t=1e-3, record_steps=record_steps,
                                      device="cpu").numpy()
    for i in range(3):
        ref = jns.solve_navier_stokes_2d(w0[i], T=0.5, delta_t=1e-3,
                                         record_steps=record_steps)
        got = port[:, i] if record_steps > 1 else port[i]
        assert got.shape == ref.shape and got.dtype == np.float64
        assert _rel(got, ref) <= TOL


def test_generated_files_match_jax(tmp_path):
    jns.generate_navier_stokes_files(tmp_path / "jax", n_train=3, n_test=2, res=16, T=0.25,
                                     seed=4)
    tns.generate_navier_stokes_files(tmp_path / "port", n_train=3, n_test=2, res=16, T=0.25,
                                     seed=4, device="cpu")
    for split in ("train", "test"):
        ref = load_pt_as_numpy(tmp_path / "jax" / f"nsforcing_{split}_16.pt")
        got = load_pt_as_numpy(tmp_path / "port" / f"nsforcing_{split}_16.pt")
        assert got["x"].dtype == got["y"].dtype == np.float32
        np.testing.assert_array_equal(got["x"], ref["x"])
        assert got["y"].shape == ref["y"].shape == (3 if split == "train" else 2, 16, 16)
        assert _rel(got["y"], ref["y"]) <= TOL
    # a split of no samples is not written
    tns.generate_navier_stokes_files(tmp_path / "none", n_train=0, n_test=1, res=8, T=0.01,
                                     device="cpu")
    assert sorted(p.name for p in (tmp_path / "none").iterdir()) == ["nsforcing_test_8.pt"]


def _jax_generate_script():
    spec = importlib.util.spec_from_file_location("jax_generate_ns_data",
                                                  ROOT / "scripts/generate_ns_data.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generate_ns_data_matches_the_jax_script(tmp_path, monkeypatch):
    args = ["--res", "16", "--train-traj", "2", "--test-traj", "1", "--T", "2",
            "--batch", "2", "--seed", "6"]
    monkeypatch.setattr(sys, "argv", ["generate_ns_data.py", *args, "--out",
                                      str(tmp_path / "jax")])
    _jax_generate_script().main()
    # the port's default directory, pointed at tmp_path
    monkeypatch.setattr(tns, "DATA_ROOT", tmp_path / "port")
    written = generate_ns_data.main([*args, "--device", "cpu"])
    assert sorted(written) == ["test", "train"]
    for split, n_traj in (("train", 2), ("test", 1)):
        ref = np.load(tmp_path / "jax/ns_raw" / f"nsforcing_traj_{split}_16.npy")
        got = np.load(tmp_path / "port/ns_raw" / f"nsforcing_traj_{split}_16.npy")
        assert got.shape == ref.shape == (n_traj, 3, 16, 16)
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])  # the GRF draws
        for b in range(n_traj):
            for s in range(1, 3):
                assert _rel(got[b, s], ref[b, s]) <= TOL, (split, b, s)
        ref_pairs = load_pt_as_numpy(tmp_path / "jax" / f"nsforcing_{split}_16.pt")
        got_pairs = load_pt_as_numpy(written[split])
        assert got_pairs["x"].shape == ref_pairs["x"].shape == (2 * n_traj, 16, 16)
        for k in ("x", "y"):  # the same pairs in the same shuffled order
            assert _rel(got_pairs[k], ref_pairs[k]) <= TOL, (split, k)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """A train and a test file at 16² (and a test file at 8²), as the JAX
    generator writes them."""
    root = tmp_path_factory.mktemp("ns")
    jns.generate_navier_stokes_files(root, n_train=12, n_test=5, res=16, T=0.05, seed=1)
    jns.generate_navier_stokes_files(root, n_train=0, n_test=4, res=8, T=0.05, seed=2)
    return root


def _batches(loader):
    return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _same_loader(got, ref):
    got, ref = _batches(got), _batches(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in g:
            np.testing.assert_array_equal(g[k], r[k])


def _same_processor(got, ref):
    for side in ("in_normalizer", "out_normalizer"):
        g, r = getattr(got, side), getattr(ref, side)
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(g.mean, np.asarray(r.mean), rtol=1e-6)
            np.testing.assert_allclose(g.std, np.asarray(r.std), rtol=1e-6)
            assert g.dim == r.dim


def test_load_navier_stokes_pt_matches_jax(splits, monkeypatch):
    kw = dict(n_train=10, n_tests=[5, 4], batch_size=4, test_batch_sizes=[2, 3],
              train_resolution=16, test_resolutions=[16, 8])
    ref = jns.load_navier_stokes_pt(data_root=splits, **kw)
    monkeypatch.setattr(tns, "DATA_ROOT", splits)  # the default root, pointed at the files
    got = tns.load_navier_stokes_pt(device="cpu", **kw)
    for _ in range(2):  # two epochs of the shuffling train loader
        _same_loader(got[0], ref[0])
    assert sorted(got[1]) == sorted(ref[1]) == [8, 16]
    for res in (16, 8):
        _same_loader(got[1][res], ref[1][res])
    _same_processor(got[2], ref[2])


@pytest.mark.parametrize("kw", [
    dict(encode_input=True, encode_output=True),
    dict(encode_input=False, encode_output=True, input_subsampling_rate=2,
         output_subsampling_rate=2),
    dict(encode_input=True, encode_output=False, encoding="pixel-wise"),
], ids=["channel-wise", "subsampled", "pixel-wise"])
def test_pt_dataset_matches_jax(splits, kw):
    common = dict(root_dir=splits, dataset_name="nsforcing", n_train=7, n_tests=[3],
                  batch_size=4, test_batch_sizes=[3], train_resolution=16,
                  test_resolutions=[16], **kw)
    got, ref = tpt.PTDataset(**common), jpt.PTDataset(**common)
    np.testing.assert_array_equal(got.train_db.arrays["x"], ref.train_db.arrays["x"])
    np.testing.assert_array_equal(got.train_db.arrays["y"], ref.train_db.arrays["y"])
    np.testing.assert_array_equal(got.test_dbs[16].arrays["x"], ref.test_dbs[16].arrays["x"])
    _same_processor(got.data_processor, ref.data_processor)


def test_navier_stokes_dataset_matches_jax(splits):
    kw = dict(n_train=6, n_tests=[4], batch_size=2, test_batch_sizes=[2],
              train_resolution=16, test_resolutions=[16])
    got = tns.NavierStokesDataset(splits, device="cpu", **kw)
    ref = jns.NavierStokesDataset(splits, **kw)
    np.testing.assert_array_equal(got.train_db.arrays["y"], ref.train_db.arrays["y"])
    _same_processor(got.data_processor, ref.data_processor)


def test_loader_generates_missing_files_into_the_default_root(tmp_path, monkeypatch):
    monkeypatch.setattr(tns, "DATA_ROOT", tmp_path / "default")
    monkeypatch.setattr(tns, "generate_navier_stokes_files", _small_generator(tns))
    train, tests, processor = tns.load_navier_stokes_pt(
        n_train=4, n_tests=[2], batch_size=2, test_batch_sizes=[2], train_resolution=8,
        test_resolutions=[8], device="cpu")
    assert sorted(p.name for p in (tmp_path / "default").iterdir()) == [
        "nsforcing_test_8.pt", "nsforcing_train_8.pt"]
    assert len(train) == 2 and len(tests[8]) == 1 and processor.in_normalizer is not None


def _small_generator(module):
    full = module.generate_navier_stokes_files

    def generate(root, **kw):
        return full(root, T=0.01, **kw)  # a short solve: the files, not the flow, are checked

    return generate
