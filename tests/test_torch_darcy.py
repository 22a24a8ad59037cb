"""The Darcy recipe in the port against the JAX package.

The generator and the loaders run in both packages on the test's own
directories (``generate_darcy_files`` of each package first, then the
loaders with ``data_root``, so the JAX loader never generates into its
package): the arrays are equal to the bit, and so are the batches and the
normalizers' statistics. ``scripts/train_darcy.py`` of each package runs 2
epochs at a tiny size on one set of files from the JAX Trainer's initial
weights (``PRNGKey(0)``, converted for the port): the ``final:`` metrics
within ``rtol=1e-5`` (the same f32 steps, with sums in another order, as
``tests/test_torch_train_script.py`` holds the NS script). A model with
BatchNorm is refused by both Trainers.
"""

import functools
import importlib.util
import re
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import darcy as jdarcy
from neuraloperator_tpu.data.datasets import synthetic as jsyn
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.config import DarcyConfig
from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
from neuraloperator_tpu_torch.data.datasets import synthetic as tsyn
from neuraloperator_tpu_torch.scripts import train_darcy as tscript

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
ARGS = ["--data.n_train", "16", "--data.n_tests", "[8,8]", "--data.test_batch_sizes", "[4,4]",
        "--data.batch_size", "4", "--model.n_modes", "[8,8]", "--model.hidden_channels", "8",
        "--model.n_layers", "2", "--opt.n_epochs", "2", "--opt.step_size", "1"]


def _pt(path):
    return {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same small Darcy set written by each package's generator."""
    root = tmp_path_factory.mktemp("darcy")
    for name, gen in (("jax", jsyn.generate_darcy_files), ("port", tsyn.generate_darcy_files)):
        gen(root / name, n_train=16, n_test=8, resolutions=(16, 32), seed=0)
    return root


def test_solver_is_the_jax_solver():
    rng = np.random.default_rng(1)
    coef = np.where(jsyn.gaussian_random_field(rng, 12) >= 0, 12.0, 3.0)
    np.testing.assert_array_equal(tsyn.solve_darcy(coef), jsyn.solve_darcy(coef))


@pytest.mark.parametrize("name", ["darcy_train_16.pt", "darcy_test_16.pt", "darcy_test_32.pt"])
def test_generated_files_are_equal_to_the_bit(files, name):
    want, got = _pt(files / "jax" / name), _pt(files / "port" / name)
    assert set(got) == set(want) == {"x", "y"}
    for key in ("x", "y"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
    assert set(np.unique(got["x"])) <= {3.0, 12.0}


def test_load_darcy_flow_small_matches_jax(files):
    kwargs = dict(n_train=12, n_tests=[8, 6], batch_size=4, test_batch_sizes=[4, 3],
                  test_resolutions=[16, 32])
    jtrain, jtests, jdp = jdarcy.load_darcy_flow_small(**kwargs, data_root=str(files / "jax"))
    ttrain, ttests, tdp = tdarcy.load_darcy_flow_small(**kwargs, data_root=str(files / "port"))
    assert len(ttrain) == len(jtrain) == 3
    for epoch in range(2):  # the seeded shuffle, epoch after epoch
        for jb, tb in zip(jtrain, ttrain):
            assert tb["x"].shape == (4, 1, 16, 16)
            for key in ("x", "y"):
                np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(jb[key]))
    assert sorted(ttests) == sorted(jtests) == [16, 32]
    for res in (16, 32):
        jbatches, tbatches = list(jtests[res]), list(ttests[res])
        assert len(tbatches) == len(jbatches)
        for jb, tb in zip(jbatches, tbatches):
            assert tb["y"].shape[-2:] == (res, res)
            np.testing.assert_array_equal(np.asarray(tb["y"]), np.asarray(jb["y"]))
    assert tdp.in_normalizer is None and jdp.in_normalizer is None
    for key in ("mean", "std"):
        np.testing.assert_allclose(np.asarray(getattr(tdp.out_normalizer, key)),
                                   np.asarray(getattr(jdp.out_normalizer, key)), rtol=1e-6)


def test_load_darcy_pt_matches_jax(files):
    kwargs = dict(n_train=8, n_tests=[4], batch_size=4, test_batch_sizes=[2],
                  test_resolutions=[32], encode_input=True)
    jtrain, jtests, jdp = jdarcy.load_darcy_pt(**kwargs, data_root=str(files / "jax"))
    ttrain, ttests, tdp = tdarcy.load_darcy_pt(**kwargs, data_root=str(files / "port"))
    for jb, tb in zip(jtrain, ttrain):
        np.testing.assert_array_equal(np.asarray(tb["x"]), np.asarray(jb["x"]))
    assert [b["x"].shape for b in ttests[32]] == [(2, 1, 32, 32)] * 2
    np.testing.assert_allclose(np.asarray(tdp.in_normalizer.mean),
                               np.asarray(jdp.in_normalizer.mean), rtol=1e-6)


def test_other_training_resolutions_use_the_same_keyed_cache(tmp_path, monkeypatch):
    """At ``train_resolution`` != 16 both loaders generate into
    ``{tempdir}/neuraloperator_tpu_darcy_r{res}_n{n}_t{t}``. The JAX check
    of that cache asks for a training split at every resolution, which the
    generator writes at the smallest only, so both regenerate it on every
    call, to the same arrays."""
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    kwargs = dict(n_train=4, n_tests=[3], batch_size=2, test_batch_sizes=[3],
                  test_resolutions=[12], train_resolution=8)
    tdarcy.load_darcy_flow_small(**kwargs)
    cache = tmp_path / "neuraloperator_tpu_darcy_r8_n100_t50"
    assert sorted(p.name for p in cache.iterdir()) == [
        "darcy_test_12.pt", "darcy_test_8.pt", "darcy_train_8.pt"]
    port_files = {p.name: _pt(p) for p in cache.iterdir()}
    stamp = (cache / "darcy_train_8.pt").stat().st_mtime_ns
    tdarcy.load_darcy_flow_small(**kwargs)  # rewritten, as in JAX
    assert (cache / "darcy_train_8.pt").stat().st_mtime_ns != stamp
    np.testing.assert_array_equal(_pt(cache / "darcy_train_8.pt")["y"],
                                  port_files["darcy_train_8.pt"]["y"])
    jdarcy.load_darcy_flow_small(**kwargs, data_root=str(tmp_path / "jax"))
    for name, arrays in port_files.items():
        want = _pt(tmp_path / "jax" / name)
        for key in ("x", "y"):
            np.testing.assert_array_equal(arrays[key], want[key])


def test_the_default_root_is_the_ports_own(tmp_path, monkeypatch):
    """Without ``data_root`` the port generates into its own package's data
    directory (``DATA_ROOT``, gitignored), never into the JAX package."""
    assert tdarcy.DATA_ROOT.parts[-4:] == ("neuraloperator_tpu_torch", "data", "datasets",
                                           "data")
    monkeypatch.setattr(tdarcy, "DATA_ROOT", tmp_path / "default")
    tdarcy.load_darcy_flow_small(n_train=4, n_tests=[2], batch_size=2, test_batch_sizes=[2],
                                 test_resolutions=[16])
    assert (tmp_path / "default" / "darcy_train_16.pt").exists()
    assert _pt(tmp_path / "default" / "darcy_train_16.pt")["x"].shape == (100, 16, 16)
    monkeypatch.setattr(tdarcy, "DATA_ROOT", tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="darcy_train_16"):
        tdarcy.load_darcy_pt(n_train=2, n_tests=[2], batch_size=2, test_batch_sizes=[2])


def test_darcy_config_has_the_jax_defaults():
    from neuraloperator_tpu.config import DarcyConfig as JDarcyConfig

    assert DarcyConfig().to_dict() == JDarcyConfig().to_dict()
    cfg = DarcyConfig().to_dict()
    assert cfg["model"]["n_modes"] == [16, 16] and cfg["model"]["hidden_channels"] == 24
    assert cfg["data"]["n_train"] == 1000 and cfg["opt"]["n_epochs"] == 300


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_darcy",
                                                  ROOT / "scripts/train_darcy.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _final(out: str) -> str:
    return re.findall(r"^final: .*$", out, re.M)[-1]


def test_the_entry_point_matches_the_jax_script(files, monkeypatch, capsys):
    """Both scripts, 2 epochs on the same files from the JAX Trainer's
    initial weights: the printed metrics and parameter count agree."""
    from neuraloperator_tpu.models import get_model as jget_model
    from neuraloperator_tpu_torch.models import get_model

    module = _jax_script()
    monkeypatch.setattr(module, "load_darcy_flow_small", functools.partial(
        jdarcy.load_darcy_flow_small, data_root=str(files / "jax")))
    monkeypatch.setattr(tdarcy, "DATA_ROOT", files / "port")
    monkeypatch.setattr(sys, "argv", ["train_darcy.py", *ARGS])
    want = module.main()
    jax_out = capsys.readouterr().out

    config = module.make_config_from_cli(module.DarcyConfig, ARGS)
    params = jax.jit(lambda r: jget_model(config.to_dict()).init(
        r, jnp.zeros((4, 1, 16, 16))))(jax.random.PRNGKey(0))["params"]

    def from_jax_init(cfg, device):
        model = get_model(cfg, device=device)
        model.load_state_dict(convert.convert_flax_params(params, model.state_dict(),
                                                          device=device))
        return model

    monkeypatch.setattr(tscript, "get_model", from_jax_init)
    got = tscript.main([*ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    assert _final(out).startswith("final: {'train_err'")
    n_params = re.findall(r"^model parameters: (\d+)$", out, re.M)
    assert n_params == re.findall(r"^model parameters: (\d+)$", jax_out, re.M)
    assert set(got) == set(want) == {"train_err", "epoch_time", "16_h1", "16_l2", "32_h1",
                                     "32_l2"}
    for k in ("train_err", "16_h1", "16_l2", "32_h1", "32_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    assert got["train_err"] < 1e3 and all(np.isfinite(v) for v in got.values())


def test_distribution_is_not_ported():
    with pytest.raises(NotImplementedError, match="distribution"):
        tscript.main(["--distributed.use_distributed", "true", "--device", "cpu"])


def test_batch_norm_models_are_refused_as_the_jax_trainer_refuses_them(files):
    """The JAX Trainer applies its model to ``{"params": ...}`` alone, so a
    ``norm="batch_norm"`` FNO finds no ``batch_stats`` at its first step;
    the port's Trainer refuses it there too."""
    from flax.errors import ScopeCollectionNotFound

    from neuraloperator_tpu.losses import H1Loss as JH1
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.training import Trainer as JTrainer
    from neuraloperator_tpu.training.optimizer import build_optimizer as jbuild
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    kwargs = dict(n_train=4, n_tests=[4], batch_size=2, test_batch_sizes=[2],
                  test_resolutions=[16])
    opt = DarcyConfig().opt
    jtrain, jtests, jdp = jdarcy.load_darcy_flow_small(**kwargs, data_root=str(files / "jax"))
    jtrainer = JTrainer(model=JFNO(n_modes=(4, 4), in_channels=1, out_channels=1,
                                   hidden_channels=4, n_layers=1, norm="batch_norm"),
                        n_epochs=1, data_processor=jdp, verbose=False)
    with pytest.raises(ScopeCollectionNotFound):
        jtrainer.train(train_loader=jtrain, test_loaders=jtests, optimizer=jbuild(opt, 2),
                       training_loss=JH1(d=2))
    ttrain, ttests, tdp = tdarcy.load_darcy_flow_small(**kwargs, data_root=str(files / "port"))
    model = FNO((4, 4), 1, 1, 4, n_layers=1, norm="batch_norm", device="cpu")
    trainer = Trainer(model=model, n_epochs=1, data_processor=tdp, device="cpu")
    with pytest.raises(ValueError, match="ScopeCollectionNotFound"):
        trainer.train(ttrain, ttests, build_optimizer(opt, 2), training_loss=H1Loss(d=2))
    with pytest.raises(ValueError, match="batch_stats"):
        trainer.evaluate(trainer._build_eval_step({"h1": H1Loss(d=2)}), ttests[16], "16")
