"""The port's ``train_burgers``, ``train_burgers_pino`` and ``train_burgers_rno``
against the JAX scripts, each on a 2-epoch cut.

Each port script starts from the JAX run's initial weights (the JAX
Trainer's ``PRNGKey(0)`` init, or the scripts' own ``PRNGKey(0)`` init),
converted, and sees the same data in the same orders:
- ``train_burgers``: both read the same ``burgers_*_16.pt`` pairs, written
  into a temporary directory by the port's generator (the JAX loader is
  pointed there; its own generator's files hold non-finite pairs, ROADMAP
  §C); both loaders shuffle from ``RandomState(0)``;
- ``train_burgers_pino``: the JAX script reads its package's tracked
  ``burgers_pino_*_16.pt``, the port copies of them in a temporary
  directory; both loaders shuffle from ``RandomState(0)`` after one draw;
- ``train_burgers_rno``: numpy's global state is seeded with 0 before the
  JAX script, whose epoch orders come from it; the port draws them from
  ``RandomState(0)``.

Bounds: each final figure within 1e-5 relative of JAX's, as the other
scripts are held (the same f32 steps, sums in another order; a CPU probe
of these cuts read at most 7.0e-7). Nothing is written into the JAX
package: the test checks its data directory before and after.
"""

import importlib.util
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import burgers as jburgers
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import burgers as tburgers
from neuraloperator_tpu_torch.data.datasets.synthetic import generate_burgers_files
from neuraloperator_tpu_torch.scripts import train_burgers as tfno1d
from neuraloperator_tpu_torch.scripts import train_burgers_pino as tpino
from neuraloperator_tpu_torch.scripts import train_burgers_rno as trno

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_DATA = ROOT / "neuraloperator_tpu/data/datasets/data"
TOL = 1e-5


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / f"scripts/{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jax_run(monkeypatch):
    """JAX's ``main`` of a script on argv; the JAX matmul precision its
    ``setup`` changes is restored afterwards, and its package's data
    directory must hold the same files after the run."""
    precision = jax.config.jax_default_matmul_precision
    before = sorted(p.name for p in JAX_DATA.iterdir())

    def run(module, argv):
        monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py", *argv])
        return module.main()

    yield run
    jax.config.update("jax_default_matmul_precision", precision)
    assert sorted(p.name for p in JAX_DATA.iterdir()) == before


def _from_jax(params):
    def load(model):
        model.load_state_dict(convert.convert_flax_params(params, model.state_dict(),
                                                          device="cpu"))
        return model
    return load


def test_burgers_script_matches_the_jax_script(jax_run, monkeypatch, tmp_path, capsys):
    generate_burgers_files(tmp_path, n_train=100, n_test=50, res=16)
    monkeypatch.setattr(jburgers, "_CANDIDATE_ROOTS", [tmp_path])
    monkeypatch.setattr(tburgers, "DATA_ROOT", tmp_path)
    argv = ["--opt.n_epochs", "2", "--eval_interval", "1"]
    module = _jax_script("train_burgers")
    expected = jax_run(module, argv)
    capsys.readouterr()
    config = module.BurgersConfig()
    jmodel = module.get_model(config.to_dict())
    params = jax.jit(lambda r: jmodel.init(r, x=jnp.zeros((16, 1, 16))))(
        jax.random.PRNGKey(0))["params"]
    build = tfno1d.build_model
    monkeypatch.setattr(tfno1d, "build_model",
                        lambda *a, **k: _from_jax(params)(build(*a, **k)))
    got = tfno1d.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(got) == set(expected)
    for key in ("train_err", "16_h1", "16_l2"):
        np.testing.assert_allclose(got[key], expected[key], rtol=TOL, err_msg=key)
    assert "model parameters: 30553" in out


def _epoch_lines(text):
    return re.findall(r"^\[(\d+)\] total=([0-9.]+) weights=(\[.*?\]) parts=(\[.*?\])$", text,
                      re.M)


@pytest.mark.parametrize("aggregator", ["relobralo", "softadapt"])
def test_pino_script_matches_the_jax_script(jax_run, monkeypatch, tmp_path, capsys,
                                            aggregator):
    for split in ("train", "test"):
        shutil.copy(JAX_DATA / f"burgers_pino_{split}_16.pt", tmp_path)
    monkeypatch.setattr(tburgers, "DATA_ROOT", tmp_path)
    argv = ["--n_epochs", "3", "--aggregator", aggregator]
    module = _jax_script("train_burgers_pino")
    jax_run(module, argv)
    jax_out = capsys.readouterr().out
    jmodel = module.FNO(n_modes=(8, 8), in_channels=1, out_channels=1, hidden_channels=24,
                        n_layers=4)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 16, 16)))["params"]
    build = tpino.build_model
    monkeypatch.setattr(tpino, "build_model", lambda *a, **k: _from_jax(params)(build(*a, **k)))
    got = tpino.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    expected = float(re.findall(r"test l2 \(sum-reduced batches\): (\S+)", jax_out)[-1])
    np.testing.assert_allclose(got["test_l2"], expected, rtol=TOL)
    jlines, lines = _epoch_lines(jax_out), _epoch_lines(out)
    assert len(lines) == len(jlines) == 3
    for (epoch, total, weights, parts), (jepoch, jtotal, jweights, jparts) in zip(lines, jlines):
        assert epoch == jepoch
        # printed to 5 decimals: equal, or one unit apart on a rounding edge
        np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL, atol=1.01e-5)
        # the weights printed to 3 decimals
        np.testing.assert_allclose(eval(weights), eval(jweights), rtol=0, atol=1.01e-3)
        np.testing.assert_allclose(eval(parts), eval(jparts), rtol=TOL, atol=2e-5)


def test_rno_script_matches_the_jax_script(jax_run, monkeypatch, capsys):
    argv = ["--n_epochs", "2"]
    module = _jax_script("train_burgers_rno")
    np.random.seed(0)
    jax_run(module, argv)
    jax_out = capsys.readouterr().out
    jmodel = module.RNO(n_modes=(8,), in_channels=1, out_channels=1, hidden_channels=24,
                        n_layers=2)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 1, 32)))["params"]
    build = trno.build_model
    monkeypatch.setattr(trno, "build_model", lambda *a, **k: _from_jax(params)(build(*a, **k)))
    got = trno.main([*argv, "--device", "cpu"])
    expected = float(re.findall(r"^test l2: (\S+)$", jax_out, re.M)[-1])
    jtrain = [float(v) for v in re.findall(r"train l2 (\S+)", jax_out)]
    np.testing.assert_allclose(got["test_l2"], expected, rtol=TOL)
    np.testing.assert_allclose(got["train_l2"], jtrain, rtol=TOL, atol=1e-5)


def test_rno_script_data_are_the_jax_scripts():
    """The windows come from the same generator draws and solver."""
    config = trno.RNOConfig(n_train=3, n_test=2)
    x_train, y_train, x_test, y_test = trno.make_data(config)
    assert x_train.shape == (3, 4, 1, 32) and y_train.shape == (3, 1, 32)
    assert x_test.shape == (2, 4, 1, 32) and np.isfinite(x_train).all()
    # the first window's frames from the JAX package's solver
    from neuraloperator_tpu.data.datasets.synthetic import solve_burgers_trajectory

    rng = np.random.default_rng(0)
    grid = np.linspace(0, 2 * np.pi, 32, endpoint=False)
    coef = rng.standard_normal(4) / np.arange(1, 5)
    u0 = sum(c * np.sin((k + 1) * grid) for k, c in enumerate(coef))
    traj = solve_burgers_trajectory(u0, visc=0.05, nt=5, steps_per_frame=100)
    assert np.array_equal(x_train[0, :, 0], traj[:4].astype(np.float32))
    assert np.array_equal(y_train[0, 0], traj[4].astype(np.float32))
