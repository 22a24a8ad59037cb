"""``scripts/train_family_quality.py`` in the port against the JAX script.

Both scripts run UNO and LocalNO 2 epochs on 32 pairs, and CODANO 1 epoch
on 16, on one small set of Darcy files written by each package's generator
(equal to the bit, ``tests/test_torch_darcy.py``), with the loaders
monkeypatched onto those files and cut to 8 test pairs per resolution (at
16² only for CODANO: its JAX run spends some 30 s compiling each
evaluation shape). The port starts from the JAX Trainer's initial weights
(``PRNGKey(0)`` on the first batch), converted. The final metrics agree
within ``rtol=1e-5`` for UNO and LocalNO: the same f32 steps, with sums in
another order, as the Darcy script is held. CODANO is held to
``rtol=2e-4``: its factorized Tucker contractions run as pairwise einsum
plans that differ from the ones JAX's ``einsum`` picks (ROADMAP §C), so
each forward rounds in another order (2e-6 relative at the init), and
AdamW's normalized steps carry that rounding into the metrics: the JAX
script itself, run jitted and then eagerly (``jax.disable_jit``), reads
16_h1 9.48967 and 9.49007 after this epoch, 4.2e-5 apart.
Each family's recorded configuration also builds in both packages with the
same parameter names and shapes (``convert.check_flax_params``) and the
same parameter count.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import darcy as jdarcy
from neuraloperator_tpu.data.datasets import synthetic as jsyn
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
from neuraloperator_tpu_torch.data.datasets import synthetic as tsyn
from neuraloperator_tpu_torch.scripts import train_family_quality as tscript

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_TRAIN, BATCH = 32, 8
ARGS = {"uno": ["--n_train", str(N_TRAIN), "--n_epochs", "2"],
        "local_no": ["--n_train", str(N_TRAIN), "--n_epochs", "2"],
        "codano": ["--n_train", "16", "--n_epochs", "1"]}
COMMON = ["--step_size", "1", "--eval_interval", "1"]
RESOLUTIONS = {"uno": [16, 32], "local_no": [16, 32], "codano": [16]}
TOL = {"uno": 1e-5, "local_no": 1e-5, "codano": 2e-4}
# BASELINE.md:722-726 (the recorded rows' parameter counts)
N_PARAMS = {"uno": 407_521, "local_no": 703_465, "codano": 219_721}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("darcy")
    for name, gen in (("jax", jsyn.generate_darcy_files), ("port", tsyn.generate_darcy_files)):
        gen(root / name, n_train=N_TRAIN, n_test=8, resolutions=(16, 32), seed=0)
    return root


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_family_quality",
                                                  ROOT / "scripts/train_family_quality.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _loader(load, root, resolutions):
    """The script's loader on ``root``, with 8 test pairs per resolution."""
    def load_small(**kwargs):
        return load(**{**kwargs, "n_tests": [8] * len(resolutions),
                       "test_batch_sizes": [16] * len(resolutions),
                       "test_resolutions": resolutions, "data_root": str(root)})
    return load_small


def _jax_params(module, family):
    model = module.build_model(family, 16)
    return jax.jit(lambda r: model.init(r, x=jnp.zeros((BATCH, 1, 16, 16))))(
        jax.random.PRNGKey(0))["params"]


@pytest.mark.parametrize("family", ["uno", "local_no", "codano"])
def test_recorded_configs_have_the_jax_parameters(family):
    module = _jax_script()
    shapes = jax.eval_shape(lambda r: module.build_model(family, 16).init(
        r, x=jnp.zeros((1, 1, 16, 16))), jax.random.PRNGKey(0))["params"]
    model = tscript.build_model(family, 16, device="meta")
    convert.check_flax_params(shapes, model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == N_PARAMS[family]


@pytest.mark.parametrize("family", ["uno", "local_no", "codano"])
def test_the_entry_point_matches_the_jax_script(family, files, monkeypatch, capsys):
    module = _jax_script()
    monkeypatch.setattr(module, "load_darcy_flow_small",
                        _loader(jdarcy.load_darcy_flow_small, files / "jax", RESOLUTIONS[family]))
    recorded = {}

    class RecordingTrainer(module.Trainer):
        def train(self, *args, **kwargs):
            recorded.update(super().train(*args, **kwargs))
            return recorded

    monkeypatch.setattr(module, "Trainer", RecordingTrainer)
    monkeypatch.setattr(sys, "argv", ["train_family_quality.py", "--family", family,
                                      *ARGS[family], *COMMON])
    module.main()
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    params = _jax_params(module, family)
    build = tscript.build_model

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(convert.convert_flax_params(params, model.state_dict(),
                                                          device="cpu"))
        return model

    monkeypatch.setattr(tscript, "build_model", from_jax_init)
    monkeypatch.setattr(tscript, "load_darcy_flow_small",
                        _loader(tdarcy.load_darcy_flow_small, files / "port", RESOLUTIONS[family]))
    got = tscript.main(["--family", family, *ARGS[family], *COMMON, "--device", "cpu"])
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[-1])
    assert len(re.findall(r"^\[\d+\] ", out, re.M)) == jax_line["n_epochs"]
    assert {k: line[k] for k in ("family", "n_params", "n_train", "n_epochs")} == \
        {k: jax_line[k] for k in ("family", "n_params", "n_train", "n_epochs")}
    assert line["n_params"] == N_PARAMS[family]
    keys = ["train_err"] + [f"{r}_{loss}" for r in RESOLUTIONS[family] for loss in ("h1", "l2")]
    assert set(got) == set(recorded) == {"epoch_time", *keys}
    for k in keys:
        np.testing.assert_allclose(got[k], recorded[k], rtol=TOL[family], err_msg=k)
    assert all(np.isfinite(v) for v in got.values())


def test_unknown_family_is_refused():
    with pytest.raises(SystemExit):
        tscript.parse_args(["--family", "sfno"])
    with pytest.raises(ValueError):
        tscript.build_model("sfno", 16, device="cpu")
