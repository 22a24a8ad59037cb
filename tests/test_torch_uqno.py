"""UQNO, its quantile loss and ``scripts/train_uqno_darcy.py`` in the port
against the JAX package.

- ``PointwiseQuantileLoss``: value and gradient in both reductions, within
  ``rtol=1e-6`` (the same f32 elementwise ops and means);
- ``UQNO``: the pair of outputs within 1e-5 relative l2 of the flax
  module's, from converted parameters; the base gets no gradient (None in
  the port, zeros through JAX's ``stop_gradient``), the residual's within
  1e-4 per leaf;
- ``get_coeff_quantile_idx``: equal to the JAX function's;
- the entry point against the JAX script, 2 + 2 epochs at a tiny size
  (64 training pairs: 32 / 16 / 16, 8 test pairs) on one set of Darcy
  files written by each package's generator, from the JAX initial weights
  (``PRNGKey(0)`` for the base, ``PRNGKey(1)`` for the residual),
  converted: every printed quantile loss within ``rtol=1e-5`` (the same f32
  steps, with sums in another order) plus one unit of its fifth printed
  decimal; the calibration indices equal; the scale within 2e-3
  relative, not 1e-4: the scale is an order statistic of |error| / band
  ratios at the points where the band is thinnest, so a band near zero
  carries the steps' f32 rounding into it at 1e-3 (the JAX script itself,
  run jitted and then eagerly with ``jax.disable_jit``, reads 37.66005 and
  37.62680 here, 8.8e-4 apart; the port reads 37.63052); each coverage within the JAX script's
  printed rounding (5e-4) plus one grid point's share (pointwise) or one
  function's share (function level), since a band edge that rounds the
  other way moves one point in or out.
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

from neuraloperator_tpu.data.datasets import darcy as jdarcy
from neuraloperator_tpu.data.datasets import synthetic as jsyn
from neuraloperator_tpu.losses import PointwiseQuantileLoss as JQuantile
from neuraloperator_tpu.models import FNO as JFNO
from neuraloperator_tpu.models import UQNO as JUQNO
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
from neuraloperator_tpu_torch.data.datasets import synthetic as tsyn
from neuraloperator_tpu_torch.losses import PointwiseQuantileLoss
from neuraloperator_tpu_torch.models import FNO, UQNO
from neuraloperator_tpu_torch.scripts import train_uqno_darcy as tscript

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--n_train", "64", "--n_train_solution", "32", "--n_train_residual", "16",
        "--n_calib_residual", "16", "--base_epochs", "2", "--residual_epochs", "2"]
N_TEST = 8


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_pointwise_quantile_loss(reduction):
    pred, err = _rand(0, 3, 1, 8, 8), _rand(1, 3, 1, 8, 8)
    jloss, tloss = JQuantile(alpha=0.1, reduction=reduction), PointwiseQuantileLoss(
        alpha=0.1, reduction=reduction)
    want, jgrad = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(err)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tloss(p, torch.from_numpy(err))
    got.backward()
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-9)
    assert tloss.name == jloss.name
    with pytest.raises(ValueError):
        PointwiseQuantileLoss(0.1, reduction="max")


def _fno_kwargs():
    return dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=4, n_layers=2)


def test_uqno_detaches_its_base():
    jm = JUQNO(base_model=JFNO(**_fno_kwargs()), residual_model=JFNO(**_fno_kwargs()))
    x, r = _rand(2, 2, 1, 8, 8), _rand(3, 2, 1, 8, 8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = UQNO(FNO(**_fno_kwargs(), device="cpu"), FNO(**_fno_kwargs(), device="cpu"))
    tm.load_state_dict(convert.convert_flax_params(params, tm.state_dict(), device="cpu"))

    def loss(p):
        solution, band = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum((solution + band) * r)

    jgrads = convert.flatten_flax(jax.grad(loss)(params))
    solution, band = tm(torch.from_numpy(x))
    jsol, jband = jm.apply({"params": params}, jnp.asarray(x))
    assert not solution.requires_grad and band.requires_grad
    assert _rel_l2(solution.numpy(), jsol) <= 1e-5 and _rel_l2(band.detach().numpy(),
                                                                jband) <= 1e-5
    ((solution + band) * torch.from_numpy(r)).sum().backward()
    for name, p in tm.named_parameters():
        ref = np.asarray(jgrads[name], np.float64)
        if name.startswith("base_model."):
            assert p.grad is None and not np.any(ref), name
        else:
            assert np.linalg.norm(p.grad.double().numpy() - ref) <= 1e-4 * np.linalg.norm(ref)


@pytest.mark.parametrize("n_samples,n_gridpts", [(150, 256), (16, 256), (40, 1024), (500, 64)])
def test_quantile_indices_are_the_jax_scripts(n_samples, n_gridpts):
    module = _jax_script()
    for alpha, delta in ((0.1, 0.05), (0.2, 0.1)):
        assert tscript.get_coeff_quantile_idx(alpha, delta, n_samples, n_gridpts) == \
            module.get_coeff_quantile_idx(alpha, delta, n_samples, n_gridpts)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_uqno_darcy",
                                                  ROOT / "scripts/train_uqno_darcy.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _loader(load, root):
    def load_small(**kwargs):
        return load(**{**kwargs, "n_tests": [N_TEST], "data_root": str(root)})
    return load_small


def _printed(out: str) -> dict:
    cal = re.search(r"^calibration: domain_idx=(\d+) function_idx=(\d+) scale=([0-9.]+)$",
                    out, re.M)
    return {
        "losses": [float(v) for v in re.findall(r"^\[uq \d+\] quantile loss ([0-9.eE+-]+)$",
                                                out, re.M)],
        "domain_idx": int(cal.group(1)), "function_idx": int(cal.group(2)),
        "scale": float(cal.group(3)),
        "pointwise": float(re.search(r"^pointwise coverage: ([0-9.]+)", out, re.M).group(1)),
        "function": float(re.search(r"^function coverage .*: ([0-9.]+) \(", out, re.M).group(1)),
    }


def test_the_entry_point_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    for name, gen in (("jax", jsyn.generate_darcy_files), ("port", tsyn.generate_darcy_files)):
        gen(tmp_path / name, n_train=64, n_test=N_TEST, resolutions=(16,), seed=0)
    module = _jax_script()
    monkeypatch.setattr(module, "load_darcy_flow_small",
                        _loader(jdarcy.load_darcy_flow_small, tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", ["train_uqno_darcy.py", *ARGS])
    _, _, jax_scale = module.main()
    want = _printed(capsys.readouterr().out)

    params = {seed: JFNO(n_modes=(16, 16), in_channels=1, out_channels=1,
                         hidden_channels=24).init(jax.random.PRNGKey(seed),
                                                  jnp.zeros((1, 1, 16, 16)))["params"]
              for seed in (0, 1)}
    build = tscript.build_fno

    def from_jax_init(device, seed):
        model = build(device, seed)
        model.load_state_dict(convert.convert_flax_params(params[seed], model.state_dict(),
                                                          device="cpu"))
        return model

    monkeypatch.setattr(tscript, "build_fno", from_jax_init)
    monkeypatch.setattr(tscript, "load_darcy_flow_small",
                        _loader(tdarcy.load_darcy_flow_small, tmp_path / "port"))
    got = tscript.main([*ARGS, "--device", "cpu"])
    printed = _printed(capsys.readouterr().out)
    assert len(got["residual_losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(printed["losses"], want["losses"], rtol=1e-5, atol=1e-5)
    assert (printed["domain_idx"], printed["function_idx"]) == \
        (got["domain_idx"], got["function_idx"]) == (want["domain_idx"], want["function_idx"])
    assert (got["domain_idx"], got["function_idx"]) == tscript.get_coeff_quantile_idx(
        0.1, 0.05, 16, 256)
    np.testing.assert_allclose(got["scale"], jax_scale, rtol=2e-3)
    assert abs(got["pointwise"] - want["pointwise"]) <= 5e-4 + 1 / (N_TEST * 256)
    assert abs(got["function"] - want["function"]) <= 5e-4 + 1 / N_TEST
    assert isinstance(got["uqno"], UQNO)
