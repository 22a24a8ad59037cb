"""The port's ``train_sfno_swe``, ``train_mhd64`` and ``train_codano_multivar``
against the JAX scripts, each on a 2-epoch cut.

Each port script starts from the JAX run's initial weights (the JAX
Trainer's ``PRNGKey(0)`` init, or the multi-variable script's keys 0-3),
converted; the multi-variable script's epoch orders are JAX's
(``jax.random.permutation`` of ``fold_in(PRNGKey(0), epoch)``), which the
port cannot draw, fed to the port through its ``permutation``. Data: the
SFNO's pairs come from each package's own SWE generator (equal within
2e-7, ``tests/test_torch_sfno.py``); the MHD fields and the multi-variable
task are numpy in both scripts, equal to the bit.

Bounds: each final metric within 1e-5 relative of JAX's, as the
Navier-Stokes and Darcy scripts are held. The same f32 steps, with sums
in another order (the CODANO arms' Tucker contractions also in other
pairwise plans, ROADMAP §C) and, for the SFNO, data 2e-7 apart. A CPU
probe of these cuts read at most 1.2e-7 (SFNO), 7.4e-8 (MHD) and 2.5e-7
(multi-variable arms). The multi-variable zero-shot figure, which both
scripts print rounded to 4 digits, within 1e-4; the parameter counts, the
matched FNO's width and the epochs equal.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.scripts import train_codano_multivar as tmulti
from neuraloperator_tpu_torch.scripts import train_mhd64 as tmhd
from neuraloperator_tpu_torch.scripts import train_sfno_swe as tsfno

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SFNO_ARGS = ["--n_train", "32", "--n_test", "8", "--batch_size", "8", "--n_epochs", "2"]
MHD_ARGS = ["--opt.n_epochs", "2", "--data.n_train", "8", "--data.n_test", "4"]
MULTI_ARGS = ["--n_train", "32", "--n_test", "16", "--pretrain_epochs", "2", "--ft_epochs", "1",
              "--full_epochs", "2", "--no_results"]
TOL = 1e-5


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / f"scripts/{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jax_run(monkeypatch):
    """JAX's ``main`` of a script on argv; the JAX matmul precision its
    ``setup`` changes is restored afterwards."""
    precision = jax.config.jax_default_matmul_precision

    def run(module, argv):
        monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py", *argv])
        return module.main()

    yield run
    jax.config.update("jax_default_matmul_precision", precision)


def _trainer_init(model, x_shape):
    """The JAX Trainer's initial parameters (``PRNGKey(0)`` on the first batch's shape)."""
    return jax.jit(lambda r: model.init(r, x=jnp.zeros(x_shape)))(jax.random.PRNGKey(0))["params"]


def _from_jax(params):
    def load(model):
        model.load_state_dict(convert.convert_flax_params(params, model.state_dict(),
                                                          device="cpu"))
        return model
    return load


def _same(got, expected, keys, tol):
    assert set(got) == set(expected)
    for k in keys:
        np.testing.assert_allclose(got[k], expected[k], rtol=tol, err_msg=k)
    assert all(np.isfinite(v) for v in got.values())


def test_sfno_script_matches_the_jax_script(jax_run, monkeypatch, capsys):
    module = _jax_script("train_sfno_swe")
    expected = jax_run(module, SFNO_ARGS)
    capsys.readouterr()
    cfg = module.SWEConfig(n_train=32, n_test=8, batch_size=8, n_epochs=2)
    params = _trainer_init(module.SFNO(n_modes=tuple(cfg.n_modes), in_channels=3, out_channels=3,
                                       hidden_channels=cfg.hidden_channels,
                                       n_layers=cfg.n_layers,
                                       domain_padding=cfg.domain_padding),
                           (8, 3, cfg.nlat, cfg.nlon))
    build = tsfno.build_model
    monkeypatch.setattr(tsfno, "build_model", lambda *a, **k: _from_jax(params)(build(*a, **k)))
    got = tsfno.main([*SFNO_ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    keys = ["train_err", "(32, 64)_l2", "(64, 128)_l2"]
    _same(got, expected, keys, TOL)
    assert "model parameters: 296707" in out


def test_mhd_script_matches_the_jax_script(jax_run, monkeypatch, capsys):
    module = _jax_script("train_mhd64")
    expected = jax_run(module, MHD_ARGS)
    capsys.readouterr()
    config = module.MHDConfig()
    params = _trainer_init(module.get_model(config.to_dict()), (2, 3, 16, 16, 16))
    get_model = tmhd.get_model
    monkeypatch.setattr(tmhd, "get_model", lambda *a, **k: _from_jax(params)(get_model(*a, **k)))
    got = tmhd.main([*MHD_ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    _same(got, expected, ["train_err", "mhd_h1", "mhd_l2"], TOL)
    assert "params: 659027" in out


def test_mhd_script_refuses_real_data_it_cannot_read(monkeypatch):
    """Without the ``the_well`` package a run asked for real data raises the
    wrappers' ImportError, where the JAX script falls back to synthetic
    fields (with a stub package it trains: tests/test_torch_well.py)."""
    monkeypatch.setitem(sys.modules, "the_well", None)
    with pytest.raises(ImportError, match="the_well"):
        tmhd.main(["--data.well_base_path", "/data/the_well", "--device", "cpu"])


def test_multivar_script_matches_the_jax_script(jax_run, monkeypatch, capsys):
    module = _jax_script("train_codano_multivar")
    jax_run(module, MULTI_ARGS)
    jax_out = capsys.readouterr().out
    expected = json.loads(jax_out.strip().splitlines()[-1])
    cfg = tmulti.parse_args(MULTI_ARGS)
    x2, x3 = jnp.zeros((2, 2, 32, 32)), jnp.zeros((2, 3, 32, 32))
    jcod2 = module.build_codano(module.VAR_IDS[:2], cfg)
    p2 = jax.jit(lambda k: jcod2.init(k, x2, input_variable_ids=["u", "v"]))(
        jax.random.PRNGKey(0))["params"]
    _, p3 = module.extend_variable_ids(jcod2, p2, ["w"], jax.random.PRNGKey(1))
    jcod3 = module.build_codano(module.VAR_IDS, cfg)
    ps = jax.jit(lambda k: jcod3.init(k, x3, input_variable_ids=list(module.VAR_IDS)))(
        jax.random.PRNGKey(2))["params"]
    build_codano, build_fno = tmulti.build_codano, tmulti.build_fno
    extend = tmulti.extend_variable_ids

    def codano_from_jax(variable_ids, *a, **k):
        return _from_jax(p2 if len(variable_ids) == 2 else ps)(build_codano(variable_ids, *a, **k))

    def extend_as_jax(model, state, new_ids, generator=None):
        new_model, new_state = extend(model, state, new_ids, generator=generator)
        new_state["pos_enc_w"] = torch.from_numpy(np.asarray(p3["pos_enc_w"]))
        new_model.load_state_dict(new_state)
        return new_model, new_state

    def fno_from_jax(hidden_channels, *a, **k):
        model = build_fno(hidden_channels, *a, **k)
        if k.get("device") == "meta":
            return model
        jfno = module.FNO(n_modes=(8, 8), in_channels=3, out_channels=3,
                          hidden_channels=hidden_channels, n_layers=cfg.n_layers)
        return _from_jax(jax.jit(jfno.init)(jax.random.PRNGKey(3), x3)["params"])(model)

    def jax_order(seed, epoch, n):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        return torch.from_numpy(np.asarray(jax.random.permutation(key, n)))

    monkeypatch.setattr(tmulti, "build_codano", codano_from_jax)
    monkeypatch.setattr(tmulti, "extend_variable_ids", extend_as_jax)
    monkeypatch.setattr(tmulti, "build_fno", fno_from_jax)
    monkeypatch.setattr(tmulti, "permutation", jax_order)
    got = tmulti.main([*MULTI_ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    printed = json.loads(out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    assert {k: got[k] for k in ("run", "task", "n_train", "n_test")} == \
        {k: expected[k] for k in ("run", "task", "n_train", "n_test")}
    assert got["arms"].keys() == expected["arms"].keys()
    for arm, row in expected["arms"].items():
        assert got["arms"][arm].keys() == row.keys()
        for key, value in row.items():
            if key == "wall_s":
                continue
            if key in ("n_params", "epochs"):
                assert got["arms"][arm][key] == value, (arm, key)
            else:
                np.testing.assert_allclose(got["arms"][arm][key], value, rtol=TOL,
                                           atol=1e-4 if key == "zero_shot_l2" else 0,
                                           err_msg=f"{arm} {key}")
    matched = [ln for ln in jax_out.splitlines() if ln.startswith("param-matched FNO")]
    assert matched and matched == [ln for ln in out.splitlines()
                                   if ln.startswith("param-matched FNO")]


def test_multivar_matched_fno_is_counted_as_jax_counts():
    """The parameter-matched FNO's width and count, from shapes alone, at the
    script's defaults and at another width of CODANO."""
    module = _jax_script("train_codano_multivar")
    for argv in ([], ["--hidden_variable_codimension", "8", "--n_modes", "6"]):
        cfg = tmulti.parse_args(argv)
        model = module.build_codano(module.VAR_IDS, cfg)
        shapes = jax.eval_shape(lambda k: model.init(
            k, jnp.zeros((2, 3, 32, 32)), input_variable_ids=list(module.VAR_IDS)),
            jax.random.PRNGKey(2))["params"]
        n_target = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
        port = tmulti.build_codano(tmulti.VAR_IDS, cfg, device="meta")
        convert.check_flax_params(shapes, port.state_dict())
        assert sum(p.numel() for p in port.parameters()) == n_target
        best = None
        for hidden in range(8, 65, 2):
            fno = module.FNO(n_modes=(cfg.n_modes, cfg.n_modes), in_channels=3, out_channels=3,
                             hidden_channels=hidden, n_layers=cfg.n_layers)
            pf = jax.eval_shape(functools.partial(fno.init, x=jnp.zeros((2, 3, 32, 32))),
                                jax.random.PRNGKey(3))["params"]
            cnt = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(pf))
            if best is None or abs(cnt - n_target) < abs(best[1] - n_target):
                best = (hidden, cnt)
        assert tmulti.matched_fno_width(cfg, n_target) == best


def test_multivar_data_are_the_jax_arrays():
    module = _jax_script("train_codano_multivar")
    for n, n_vars, seed in ((4, 2, 10), (3, 3, 12)):
        for a, b in zip(tmulti.make_dataset(n, n_vars, seed), module.make_dataset(n, n_vars, seed)):
            assert a.dtype == np.float32 and np.array_equal(a, b)
