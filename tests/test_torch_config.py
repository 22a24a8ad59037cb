"""The port's config system (a copy of ``neuraloperator_tpu/config.py``)
parses a command line as the JAX package does.

The flagship recipe's command line (``scripts/run_flagship_v2.sh:43-53``,
with the warm start of its first launch) goes through both packages'
``make_config_from_cli`` into each training script's config tree, and the
``to_dict()`` results must be equal; so must the defaults, and the
``--key=value`` form.
"""

import importlib.util
from pathlib import Path

import pytest

from neuraloperator_tpu import config as jcfg
from neuraloperator_tpu_torch import config as tcfg
from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript

ROOT = Path(__file__).resolve().parents[1]

RECIPE = [
    "--data.n_train", "20000", "--data.train_resolution", "128",
    "--data.n_tests", "[2000]", "--data.test_resolutions", "[128]",
    "--data.test_batch_sizes", "[16]", "--data.batch_size", "8",
    "--model.n_modes", "[64,64]", "--model.hidden_channels", "64",
    "--model.projection_channel_ratio", "4",
    "--opt.n_epochs", "200", "--opt.learning_rate", "3e-5", "--opt.weight_decay", "1e-4",
    "--opt.training_loss", "h1", "--opt.step_size", "50", "--opt.gamma", "0.5",
    "--opt.opt_state", "factored",
    "--opt.mixed_precision", "false", "--device_dataset", "true", "--eval_interval", "25",
    "--save_dir", "artifacts/ns128_v2", "--save_every", "25", "--save_best", "128_l2",
    "--warm_start_from", "artifacts/ns128_f32",
]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_navier_stokes",
                                                  ROOT / "scripts/train_navier_stokes.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("argv", [RECIPE, [], ["--opt.n_epochs=3", "--model.n_modes", "(8,8)",
                                                "--epoch_scan_chunk", "25",
                                                "--resume_from_dir", "none"]],
                         ids=["recipe", "defaults", "other-forms"])
def test_training_script_configs_parse_alike(argv):
    want = jcfg.make_config_from_cli(_jax_script().NSConfig, list(argv)).to_dict()
    got = tcfg.make_config_from_cli(tscript.NSConfig, list(argv)).to_dict()
    assert got == want
    if argv is RECIPE:
        assert got["opt"]["learning_rate"] == 3e-5 and got["data"]["n_tests"] == [2000]
        assert got["model"]["n_modes"] == [64, 64] and got["device_dataset"] is True


@pytest.mark.parametrize("section", ["OptConfig", "FNOModelConfig", "DistributedConfig"])
def test_sections_have_the_jax_defaults(section):
    assert getattr(tcfg, section)().to_dict() == getattr(jcfg, section)().to_dict()


def test_device_is_the_ports_own_flag():
    device, rest = tscript._split_device(["--device", "cpu", *RECIPE[:4]])
    assert device == "cpu" and rest == RECIPE[:4]
    assert tscript._split_device(RECIPE[:2]) == ("cuda", RECIPE[:2])
