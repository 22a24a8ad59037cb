"""The port's Navier–Stokes solver against the JAX package's, on the CPU.

Tolerances: the initial fields, the spectral constants, the pairs'
order and the windows are equal exactly (the same numpy code, the same
float32 casts). The solver's snapshots agree to a relative l2 of 1e-5 per
snapshot at 32² over 2000 steps: the same float32 arithmetic in the same
order, but pocketfft (torch) and XLA's CPU FFT round differently, by about
1e-6 relative, and the flow carries that on without growing it over this
time. The analytic checks of ``tests/test_ns_solver.py`` run on the port
with that file's bounds.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import ns_solver as jns
from neuraloperator_tpu_torch.data.datasets import load_pt_as_numpy
from neuraloperator_tpu_torch.data.datasets import ns_solver as tns

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SNAPSHOT_TOL = 1e-5


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed,batch,n", [(0, 2, 32), (3, 8, 64), (10_000, 3, 17)])
def test_grf_fields_are_bit_identical(seed, batch, n):
    port = tns.gaussian_rf_vorticity(np.random.default_rng(seed), batch, n)
    ref = jns.gaussian_rf_vorticity(np.random.default_rng(seed), batch, n)
    assert port.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("n,forcing_amp", [(16, 0.1), (32, 0.1), (33, 0.0)])
def test_constants_are_equal(n, forcing_amp):
    port = tns._ns_constants(n, forcing_amp, device="cpu")
    ref = jns._ns_constants(n, forcing_amp)
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(v), err_msg=k)


def test_simulation_matches_the_jax_solver():
    w0 = jns.gaussian_rf_vorticity(np.random.default_rng(0), 2, 32)
    ref = np.asarray(jns.simulate_navier_stokes_2d(w0, T=2.0, record_dt=1.0))
    port = tns.simulate_navier_stokes_2d(w0, T=2.0, record_dt=1.0, device="cpu")
    assert port.dtype == torch.float32 and tuple(port.shape) == ref.shape == (2, 2, 32, 32)
    for b in range(2):
        for r in range(2):
            assert _rel(port[b, r].numpy(), ref[b, r]) <= SNAPSHOT_TOL, (b, r)


def test_taylor_green_exact_decay():
    """w0 = sin sin is an exact NS solution: advection vanishes, w decays
    as exp(-8 pi^2 nu t)."""
    n, nu = 32, 1e-2
    xs = np.linspace(0, 1, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    w0 = np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    out = tns.simulate_navier_stokes_2d(w0[None], visc=nu, T=0.5, dt=1e-3, record_dt=0.25,
                                        forcing_amp=0.0, device="cpu").numpy()
    assert out.shape == (1, 2, n, n)
    for i, t in enumerate((0.25, 0.5)):
        exact = w0 * np.exp(-8 * np.pi**2 * nu * t)
        assert _rel(out[0, i], exact) < 1e-3, t


def test_forced_steady_component():
    """With zero IC, the early-time solution follows the linearized forced
    response toward f / (nu * 8 pi^2) on the forced modes."""
    n, nu = 32, 1e-1
    w0 = np.zeros((1, n, n), dtype=np.float32)
    out = tns.simulate_navier_stokes_2d(w0, visc=nu, T=2.0, dt=1e-3, record_dt=2.0,
                                        device="cpu").numpy()
    xs = np.linspace(0, 1, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    f = 0.1 * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))
    expected = f / (nu * 8 * np.pi**2) * (1 - np.exp(-nu * 8 * np.pi**2 * 2.0))
    assert _rel(out[0, -1], expected) < 0.05


def test_dt_refinement_consistency():
    w0 = tns.gaussian_rf_vorticity(np.random.default_rng(0), 1, 32)
    a = tns.simulate_navier_stokes_2d(w0, T=0.5, dt=1e-3, record_dt=0.5, device="cpu")
    b = tns.simulate_navier_stokes_2d(w0, T=0.5, dt=5e-4, record_dt=0.5, device="cpu")
    assert _rel(a.numpy(), b.numpy()) < 1e-3


def test_record_dt_validation():
    with pytest.raises(ValueError, match="not a multiple"):
        tns.simulate_navier_stokes_2d(np.zeros((1, 16, 16), np.float32), T=1.0, dt=0.3,
                                      record_dt=1.0, device="cpu")


@pytest.mark.parametrize("stride", [1, 2])
def test_pairs_and_windows_are_equal(stride):
    traj = np.random.default_rng(stride).standard_normal((3, 5, 4, 4)).astype(np.float32)
    for port, ref in zip(tns.trajectories_to_pairs(traj, stride),
                         jns.trajectories_to_pairs(traj, stride)):
        np.testing.assert_array_equal(port, ref)
    for port, ref in zip(tns.trajectories_to_windows(traj, stride + 1),
                         jns.trajectories_to_windows(traj, stride + 1)):
        np.testing.assert_array_equal(port, ref)
    with pytest.raises(ValueError, match="too long"):
        tns.trajectories_to_windows(traj, 5)


def test_split_matches_generate_ns_data(tmp_path):
    """The in-memory split against the .pt file that
    ``scripts/generate_ns_data.py``'s ``stream_split`` writes with the JAX
    solver: 3 trajectories in blocks of 2 (two GRF draws from one rng),
    32², T = 3, seed 10 000."""
    spec = importlib.util.spec_from_file_location("generate_ns_data",
                                                  ROOT / "scripts/generate_ns_data.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    args = SimpleNamespace(T=3.0, record_dt=1.0, visc=1e-3, dt=1e-3, batch=2)
    (tmp_path / "raw").mkdir()
    gen.stream_split(tmp_path, tmp_path / "raw", "test", 3, 32, args, seed=10_000)
    ref = load_pt_as_numpy(tmp_path / "nsforcing_test_32.pt")

    x, y = tns.make_nsforcing_split(3, 32, 10_000, batch=2, device="cpu", T=3.0)
    assert x.shape == y.shape == ref["x"].shape == (9, 32, 32) and x.dtype == np.float32
    # the pairs whose input is an initial field are bit-identical; every
    # pair is the same pair in the same place
    w0 = jns.gaussian_rf_vorticity(np.random.default_rng(10_000), 2, 32)
    starts = [i for i in range(len(x)) if any(np.array_equal(ref["x"][i], w) for w in w0)]
    assert len(starts) == 2
    for i in range(len(x)):
        if i in starts:
            np.testing.assert_array_equal(x[i], ref["x"][i])
        assert _rel(x[i], ref["x"][i]) <= SNAPSHOT_TOL, i
        assert _rel(y[i], ref["y"][i]) <= SNAPSHOT_TOL, i
