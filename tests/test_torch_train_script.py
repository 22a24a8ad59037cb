"""The port's training entry point against the JAX package's ``scripts/train_navier_stokes.py``.

Both scripts run the flagship recipe's options at a small size on the CPU
(16², hidden 8, 8x8 modes, 2 layers, factored AdamW, H1,
``--device_dataset true``, ``--save_every``, ``--save_best``), on the same
``nsforcing`` files (the port's default root pointed at them), warm-started
from one checkpoint so that both begin at the same weights; then each
resumes its own run for one more epoch. The ``final:`` metrics must agree
within ``rtol=1e-5`` (the same f32 steps, with sums in another order; see
``tests/test_torch_trainer_recipe.py``), and each package must resume the
other's run to the same metrics.
"""

import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import navier_stokes as jns
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
MIXED_TOL = 1e-3

ARGS = [
    "--data.n_train", "16", "--data.train_resolution", "16", "--data.n_tests", "[8]",
    "--data.test_resolutions", "[16]", "--data.test_batch_sizes", "[4]",
    "--data.batch_size", "4", "--model.n_modes", "[8,8]", "--model.hidden_channels", "8",
    "--model.n_layers", "2", "--opt.learning_rate", "1e-3", "--opt.step_size", "1",
    "--opt.opt_state", "factored", "--opt.training_loss", "h1", "--opt.mixed_precision",
    "false", "--device_dataset", "true", "--eval_interval", "1", "--save_every", "1",
    "--save_best", "16_l2",
]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_navier_stokes",
                                                  ROOT / "scripts/train_navier_stokes.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jax_main(monkeypatch):
    """JAX's ``main`` on argv, its loader pointed at the test's files; the
    JAX precision setting its ``setup`` changes is restored afterwards."""
    precision = jax.config.jax_default_matmul_precision
    module = _jax_script()

    def run(argv, data_root):
        monkeypatch.setattr(module, "load_navier_stokes_pt",
                            functools.partial(jns.load_navier_stokes_pt, data_root=data_root))
        monkeypatch.setattr(sys, "argv", ["train_navier_stokes.py", *argv])
        return module.main()

    yield run
    jax.config.update("jax_default_matmul_precision", precision)


def _final(out: str) -> str:
    return re.findall(r"^final: .*$", out, re.M)[-1]


def test_the_entry_point_trains_saves_and_resumes_as_jax_does(tmp_path, monkeypatch, capsys,
                                                              jax_main):
    data = tmp_path / "data"
    jns.generate_navier_stokes_files(data, n_train=16, n_test=8, res=16, T=0.05, seed=3)
    monkeypatch.setattr(tns, "DATA_ROOT", data)  # the port's default root
    # one starting point for both: the JAX model's weights, as a warm-start checkpoint
    config = jax_script_config(ARGS)
    from neuraloperator_tpu.models import get_model

    params = get_model(config.to_dict()).init(jax.random.PRNGKey(4),
                                              np.zeros((1, 1, 16, 16), np.float32))["params"]
    jts.save_training_state(tmp_path / "init", "best_model", params)
    first = ["--opt.n_epochs", "2", "--warm_start_from", str(tmp_path / "init")]

    want = jax_main([*ARGS, *first, "--save_dir", str(tmp_path / "jax")], data)
    capsys.readouterr()
    got = tscript.main([*ARGS, *first, "--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warm-starting params from" in out and "params: " in out
    assert _final(out).startswith("final: {'train_err'")
    _same(got, want)
    for name in ("model.msgpack", "optimizer.msgpack", "best_model.msgpack", "manifest.json",
                 "data_processor.json", "model_metadata.json"):
        assert (tmp_path / "port" / name).exists(), name

    # each package resumes the other's run for a third epoch, to the same metrics
    resume = ["--opt.n_epochs", "3", "--resume_from_dir"]
    want = jax_main([*ARGS, *resume, str(tmp_path / "port"), "--save_dir",
                     str(tmp_path / "port")], data)
    got = tscript.main([*ARGS, *resume, str(tmp_path / "jax"), "--save_dir",
                        str(tmp_path / "jax"), "--device", "cpu"])
    assert "resuming from" in capsys.readouterr().out
    _same(got, want)


def test_the_mixed_precision_run_matches_jax(tmp_path, monkeypatch, capsys, jax_main):
    """The JAX package's mixed-precision flags (``scripts/run_round4_post.sh:23-24``)
    on both scripts, 2 epochs from one warm start: bf16 spectral weights, the
    "mixed" blocks and the Trainer's half policy. jitted JAX keeps bf16 chains
    in f32 between ops where the port rounds each (see
    ``tests/test_torch_mixed_precision.py``), so each final metric within
    MIXED_TOL relative (1.8e-4 measured), and the saved spectral weights
    are bf16 in both runs."""
    data = tmp_path / "data"
    jns.generate_navier_stokes_files(data, n_train=16, n_test=8, res=16, T=0.05, seed=3)
    monkeypatch.setattr(tns, "DATA_ROOT", data)
    mixed = [a if a != "false" else "true" for a in ARGS] + [
        "--model.weight_dtype", "bfloat16", "--model.fno_block_precision", "mixed"]
    assert "--opt.mixed_precision" in mixed and "false" not in mixed
    config = jax_script_config(mixed)
    from neuraloperator_tpu.models import get_model

    params = get_model(config.to_dict()).init(jax.random.PRNGKey(4),
                                              np.zeros((1, 1, 16, 16), np.float32))["params"]
    jts.save_training_state(tmp_path / "init", "best_model", params)
    first = ["--opt.n_epochs", "2", "--warm_start_from", str(tmp_path / "init")]
    want = jax_main([*mixed, *first, "--save_dir", str(tmp_path / "jax")], data)
    got = tscript.main([*mixed, *first, "--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    capsys.readouterr()
    assert set(got) == set(want)
    for k in ("train_err", "16_h1", "16_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=MIXED_TOL, err_msg=k)
    for run in ("jax", "port"):
        saved = jts.load_training_state(tmp_path / run, "model", params)[0]
        assert saved["fno_blocks"]["conv_0"]["w_weight"].dtype == np.dtype("bfloat16"), run
    # the sidecar says weight_dtype "bfloat16": from_checkpoint rebuilds the bf16 model
    from neuraloperator_tpu_torch.models import from_checkpoint

    rebuilt = from_checkpoint(tmp_path / "port", "model", device="cpu")
    assert rebuilt.fno_blocks.conv_0.w_weight.dtype == torch.bfloat16
    assert rebuilt.fno_blocks.conv_0.fno_block_precision == "mixed"


def jax_script_config(argv):
    from neuraloperator_tpu.config import make_config_from_cli

    return make_config_from_cli(_jax_script().NSConfig, list(argv))


def _same(got, want):
    assert set(got) == set(want) == {"train_err", "epoch_time", "16_h1", "16_l2"}
    for k in ("train_err", "16_h1", "16_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


def test_unported_options_raise():
    # --opt.mixed_precision is ported (tests/test_torch_mixed_precision.py runs
    # it), and so are --opt.opt_state factored8, --opt.stochastic_rounding and
    # --opt.ema_decay (tests/test_torch_optimizer_options.py runs them), and so
    # is --patching.levels (tests/test_torch_patching.py runs it)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tscript.main(["--distributed.use_distributed", "true", "--device", "cpu"])
