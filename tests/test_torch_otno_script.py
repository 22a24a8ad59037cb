"""``train_otno_carcfd`` of the PyTorch port against the JAX script, on the
CPU.

Both packages' car-CFD generators are monkeypatched to small bodies (256
vertices), and both scripts run ``--data_source synthetic`` on one training
and one test body for 2 epochs at the script's full width (OTNO at hidden
32, 4 layers, (12, 12) modes) on a 16² latent grid, the port from the JAX
run's initial weights (the script's ``PRNGKey(0)`` init on the first body's
inputs, converted). Each script solves its own OT maps: the port's torch
Sinkhorn in float64 on the CPU, JAX's numpy one (``tests/test_torch_otno.py``
holds the two; these bodies show no near tie). Bounds: every epoch's loss
and evaluation as the JAX script prints them (5 decimals), the final test
figure within 1e-5 relative of JAX's trained weights' figure. ``--data_source
mini`` raises ``FileNotFoundError`` in both packages (``mini_car.pt`` is not
in the repository). Nothing is written into the JAX package.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuraloperator_tpu.data.datasets as jdatasets
from neuraloperator_tpu.data.datasets import ot_datamodule as jot
from neuraloperator_tpu.data.datasets import synthetic_cfd as jcfd
from neuraloperator_tpu.losses import LpLoss as JLpLoss
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.scripts import train_gino_carcfd as tgino
from neuraloperator_tpu_torch.scripts import train_otno_carcfd as totno

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_DATA = ROOT / "neuraloperator_tpu/data/datasets/data"
TOL = 1e-5
ARGV = ["--data_source", "synthetic", "--n_train", "1", "--n_test", "1", "--n_epochs", "2",
        "--eval_interval", "1", "--latent_size", "16"]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_otno_carcfd",
                                                  ROOT / "scripts/train_otno_carcfd.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _small(n_samples, **kwargs):
    rng = np.random.default_rng(0)
    return [jcfd.generate_cfd_sample(rng, n_verts=256, grid_n=4) for _ in range(n_samples)]


def _jax_inputs(sample, config):
    """The JAX script's ``prep`` of one sample, as numpy arrays."""
    verts = sample["vertices"].astype(np.float32)
    center = verts.mean(0)
    verts = (verts - center) / np.abs(verts - center).max()
    dm = jot.OTDataModule(verts, latent_size=config.latent_size, reg=config.reg, n_iters=200)
    return dm.transported_features(verts), dm.ind_dec, sample["press"].astype(np.float32)


@pytest.fixture
def jax_run(monkeypatch):
    precision = jax.config.jax_default_matmul_precision
    before = sorted(p.name for p in JAX_DATA.iterdir())

    def run(module, argv):
        monkeypatch.setattr(sys, "argv", ["train_otno_carcfd.py", *argv])
        return module.main()

    yield run
    jax.config.update("jax_default_matmul_precision", precision)
    assert sorted(p.name for p in JAX_DATA.iterdir()) == before


def test_otno_script_matches_the_jax_script(jax_run, monkeypatch, capsys):
    monkeypatch.setattr(jdatasets, "load_synthetic_cfd", _small)
    monkeypatch.setattr(tgino, "load_synthetic_cfd", _small)
    module = _jax_script()
    trained = jax_run(module, ARGV)
    jax_out = capsys.readouterr().out
    config = module.OTConfig(data_source="synthetic", n_train=1, n_test=1, n_epochs=2,
                             eval_interval=1, latent_size=16)
    train, test = (_jax_inputs(s, config) for s in _small(2))
    jm = module.OTNO(n_modes=(12, 12), in_channels=6, out_channels=1, hidden_channels=32,
                     n_layers=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(train[0]),
                              jnp.asarray(train[1]))["params"]
    l2 = JLpLoss(d=1)
    out = jm.apply({"params": trained}, jnp.asarray(test[0]), jnp.asarray(test[1]))
    expected = float(l2(out[None], jnp.asarray(test[2])[None]))

    build = totno.build_model

    def from_jax(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(convert.convert_flax_params(params, model.state_dict(),
                                                          device="cpu"))
        return model

    monkeypatch.setattr(totno, "build_model", from_jax)
    got = totno.main([*ARGV, "--device", "cpu"])
    port_out = capsys.readouterr().out
    np.testing.assert_allclose(got["test_l2"], expected, rtol=TOL)
    assert re.findall(r"final test l2: (\S+)", port_out) == re.findall(
        r"final test l2: (\S+)", jax_out)
    jtrain = [float(v) for v in re.findall(r"^\[\d+\] train l2 (\S+)", jax_out, re.M)]
    assert len(jtrain) == 2
    np.testing.assert_allclose(got["train_l2"], jtrain, rtol=0, atol=1.01e-5)
    jevals = [float(v) for v in re.findall(r"test l2 (\S+)$", jax_out, re.M)]
    np.testing.assert_allclose([got["evals"][e] for e in sorted(got["evals"])], jevals,
                               rtol=0, atol=1.01e-5)
    assert got["ot_meshes"] == 2


def test_mini_source_raises_file_not_found_as_in_jax(monkeypatch):
    with pytest.raises(FileNotFoundError, match="mini_car.pt"):
        totno.main(["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train_otno_carcfd.py"])
    with pytest.raises(FileNotFoundError, match="mini_car.pt"):
        _jax_script().main()
