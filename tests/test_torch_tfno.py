"""The port's factorized spectral layer and TFNO against the JAX package.

Small sizes throughout (hidden <= 8, modes <= 8, grids <= 16² in 2-D, 2
layers). Each flax module is initialised, its parameters go through the
port's converter into the port module, and both run the same numpy input.
The JAX side reaches the Pallas contraction in interpret mode where the
weight is rebuilt (``"reconstructed"``, or dense), as the JAX package's own
tests run it; its factorized contractions are XLA einsums.

Tolerances:
* f32 forwards of ``SpectralConv`` and of the whole TFNO: relative l2 <=
  2e-6 (f32 sums in another order; a CPU probe read up to 7.8e-7, in 1-D);
* H1 gradients of the whole TFNO, per leaf (each factor, the core, every
  other parameter): relative l2 <= 1e-4, the FNO's bound
  (``tests/test_torch_trainer.py``), each leaf against the larger of its
  own norm and 1e-3 of the whole gradient's: the projection bias's
  gradient is a sum over the grid that cancels to 1e-3 of its terms (1-D:
  -2.7e-4, 1.3e-4 relative between the packages, 4e-8 absolute);
* the "mixed" TFNO (bf16 factors) under the half policy against eager JAX:
  relative l2 <= 2e-2, the bound of bf16 products planned otherwise
  (``tests/test_torch_factorized.py``): a CPU probe read 0 in 1-D and 2-D
  (the same plans, the same roundings) and 8.0e-3 in 3-D (another plan);
* a factored AdamW state after two steps against optax: the "factored"
  policy's bounds of ``tests/test_torch_optimizer.py``;
* checkpoints: byte-identical files and bit-identical leaves both ways;
* ``train_navier_stokes`` against the JAX script: each final metric within
  1e-5 relative, as for the FNO (``tests/test_torch_train_script.py``);
* served and exported answers against JAX's: 1e-5; int8 codes and scales:
  equal; the artifact against the eager forward: equal at batch 8, 1e-6
  at other batches (the graph holds the plan of the symbolic batch's
  stand-in size 8; eager plans each batch, another order of f32 sums:
  2e-7 measured).
"""

import functools
import io
import json
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser
from jax.experimental import pallas as pl

from neuraloperator_tpu import serving as jserving
from neuraloperator_tpu.config import TFNO_Medium2d as JTFNO_Medium2d
from neuraloperator_tpu.data.datasets import navier_stokes as jns
from neuraloperator_tpu.layers import spectral_convolution as jconv
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.models import base_model as jbase
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert, serialization, serving
from neuraloperator_tpu_torch.config import TFNO_Medium2d
from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
from neuraloperator_tpu_torch.layers import SpectralConv
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.models import (
    FNO,
    TFNO,
    from_checkpoint,
    get_model,
    load_checkpoint,
    model_from_metadata,
    save_arch_metadata,
)
from neuraloperator_tpu_torch.scripts import serve_model
from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript
from neuraloperator_tpu_torch.training import build_optimizer
from neuraloperator_tpu_torch.training import training_state as tts
from neuraloperator_tpu_torch.training.trainer import half_precision_forward
from neuraloperator_tpu_torch.utils import count_model_params
from test_torch_train_script import ARGS, _final, _same, jax_main, jax_script_config  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
METADATA = ROOT / "artifacts/ns128_v2/model_metadata.json"
F32_TOL = 2e-6
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3
MIXED_TOL = 2e-2
SERVE_TOL = 1e-5
RES = 16


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _load(port_module, params):
    port_module.load_state_dict(
        convert.convert_flax_params(params, port_module.state_dict(), device="cpu"))
    return port_module


# ------------------------------------------------------------- the layer --

# (factorization, implementation, separable, n_modes, max_n_modes, grid, extra)
CONV_CASES = [
    ("tucker", "factorized", False, (8, 8), None, (16, 16), {}),
    ("tucker", "reconstructed", False, (8, 8), None, (16, 16), {}),
    ("cp", "factorized", False, (8, 8), None, (16, 16), {}),
    ("cp", "reconstructed", False, (6, 5), None, (17, 13), {}),
    ("tt", "factorized", False, (8, 8), None, (16, 16), {}),
    ("tt", "reconstructed", False, (6, 5), None, (17, 13), {}),
    ("tucker", "factorized", False, (8,), None, (32,), {}),
    ("tucker", "factorized", False, (4, 4, 4), None, (8, 9, 10), {}),
    ("tt", "reconstructed", False, (4, 4, 4), None, (8, 8, 8), {}),
    ("tucker", "factorized", False, (6, 5), (9, 4), (16, 17), {}),
    ("cp", "factorized", False, (6, 5), (9, 4), (16, 17), {}),
    ("tucker", "factorized", False, (8, 8), None, (16, 6), {}),
    ("tucker", "factorized", False, (8, 8), None, (16, 16), {"fixed_rank_modes": True}),
    ("tucker", "factorized", False, (8, 8), None, (16, 16), {"rank": (3, 4, 5, 3)}),
    ("tucker", "factorized", True, (8, 8), None, (16, 16), {}),
    ("cp", "factorized", True, (8, 8), None, (16, 16), {}),
    ("tt", "reconstructed", True, (6, 5), None, (17, 13), {}),
    (None, "factorized", True, (8, 8), None, (16, 16), {}),
]


def _conv_id(case):
    kind, impl, sep, n_modes, max_n_modes, grid, extra = case
    return "-".join([str(kind), impl[:5], "sep" if sep else "full", "x".join(map(str, n_modes)),
                     "max" if max_n_modes else "", "x".join(map(str, grid)),
                     "_".join(extra)])


@pytest.mark.parametrize("case", CONV_CASES, ids=[_conv_id(c) for c in CONV_CASES])
def test_spectral_conv_matches_jax(jax_pallas, case):
    kind, impl, separable, n_modes, max_n_modes, grid, extra = case
    channels = (6, 6) if separable else (6, 10)
    kw = dict(max_n_modes=max_n_modes, factorization=kind, implementation=impl,
              separable=separable, rank=extra.get("rank", 0.5),
              fixed_rank_modes=extra.get("fixed_rank_modes", False))
    jmodule = jconv.SpectralConv(*channels, n_modes, **kw)
    x = _rand(0, 2, channels[0], *grid)
    variables = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = _load(SpectralConv(*channels, n_modes, device="cpu", **kw), variables["params"])
    names = {f"w_{n}" for n in port.factor_names} | {"bias"}
    assert set(variables["params"]) == names
    jspec = jmodule.spec()
    assert (port.spec.kind, port.spec.shape, port.spec.ranks) == \
        (jspec.kind, jspec.shape, jspec.ranks)
    expected = np.asarray(jmodule.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        actual = port(torch.from_numpy(x)).numpy()
    assert actual.shape == expected.shape
    assert _rel_l2(actual, expected) <= F32_TOL


def test_separable_needs_equal_channels_and_implementation_is_checked():
    with pytest.raises(ValueError, match="in_channels == out_channels"):
        SpectralConv(4, 6, (4, 4), separable=True, device="cpu")
    with pytest.raises(ValueError, match="implementation"):
        SpectralConv(4, 4, (4, 4), factorization="cp", implementation="fused", device="cpu")
    with pytest.raises(ValueError, match="Unknown factorization"):
        SpectralConv(4, 4, (4, 4), factorization="svd", device="cpu")


# ------------------------------------------------------------ the model --


def _tfno_meta(n_modes=(8, 8), **overrides):
    meta = json.loads(METADATA.read_text())
    meta["_name"] = "TFNO"
    meta["init_kwargs"].update({"n_modes": list(n_modes), "hidden_channels": 8, "n_layers": 2,
                                "factorization": "tucker", "rank": 0.1, **overrides})
    return meta


def _jax_model(meta):
    kwargs = {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["init_kwargs"].items()
        if not (isinstance(v, dict) and ("__callable__" in v or "__class__" in v))
    }
    return jbase.get_model_class(meta["_name"])(**kwargs)


def _models(meta, res, seed=0):
    jmodel = _jax_model(meta)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, *res)))["params"]
    model = _load(model_from_metadata(meta, device="cpu"), params)
    return jmodel, jax.device_get(params), model


MODEL_CASES = [((8,), (32,)), ((8, 8), (16, 16)), ((4, 4, 4), (8, 9, 10))]


@pytest.mark.parametrize("implementation", ["factorized", "reconstructed"])
@pytest.mark.parametrize("n_modes,res", MODEL_CASES, ids=["1d", "2d", "3d"])
def test_whole_tfno_forward_and_h1_gradients_match_jax(jax_pallas, n_modes, res,
                                                       implementation):
    meta = _tfno_meta(n_modes, implementation=implementation)
    jmodel, params, model = _models(meta, res)
    assert isinstance(model, TFNO)
    x, y = _rand(1, 2, 1, *res), _rand(2, 2, 1, *res)
    d = len(res)

    def jloss(p):
        return jl.H1Loss(d=d)(jmodel.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    j_out = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    j_grads = convert.flatten_flax(jax.jit(jax.grad(jloss))(params))
    out = model(torch.from_numpy(x))
    assert _rel_l2(_np(out), j_out) <= F32_TOL
    H1Loss(d=d)(out, torch.from_numpy(y)).backward()
    named = dict(model.named_parameters())
    assert set(named) == set(j_grads)
    assert {n for n in named if ".w_" in n and "conv" in n} == {
        f"fno_blocks.conv_{i}.w_{f}" for i in range(2)
        for f in ("core", *(f"factor_{k}" for k in range(d + 2)))}
    floor = GRAD_FLOOR * np.linalg.norm(np.concatenate(
        [np.asarray(g, np.float64).ravel() for g in j_grads.values()]))
    for name, p in named.items():
        want = np.asarray(j_grads[name], np.float64)
        err = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), floor)
        assert err <= GRAD_TOL, name


@pytest.mark.parametrize("kind", ["cp", "tt"])
def test_cp_and_tt_fno_match_jax(jax_pallas, kind):
    meta = _tfno_meta(factorization=kind, rank=0.3)
    meta["_name"] = "FNO"
    jmodel, params, model = _models(meta, (RES, RES))
    x = _rand(3, 2, 1, RES, RES)
    with torch.no_grad():
        assert _rel_l2(model(torch.from_numpy(x)).numpy(),
                       np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))) <= F32_TOL


@pytest.mark.parametrize("n_modes,res", MODEL_CASES, ids=["1d", "2d", "3d"])
def test_mixed_tfno_under_the_half_policy_matches_eager_jax(n_modes, res):
    """bf16 factors, "mixed" blocks, every f32 parameter and input cast to
    bf16 (the Trainer's half policy), against eager JAX: every op rounded,
    as in the port. The factorized contraction's bf16 products make the
    difference from the FNO's test (``tests/test_torch_mixed_precision.py``)."""
    meta = _tfno_meta(n_modes, weight_dtype="bfloat16", fno_block_precision="mixed")
    jmodel, params, model = _models(meta, res)
    assert model.fno_blocks.conv_0.w_core.dtype == torch.bfloat16
    x = _rand(4, 2, 1, *res)
    half_params, half_kwargs = jtrainer.Trainer._half_policy(None, params, {"x": jnp.asarray(x)})
    set_contraction_backend("xla")
    try:
        with jax.disable_jit():
            want = jmodel.apply({"params": half_params}, **half_kwargs)
    finally:
        set_contraction_backend("auto")
    with torch.no_grad():
        got = half_precision_forward(model, {"x": torch.from_numpy(x)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_l2(_np(got), _np(want)) <= MIXED_TOL


def test_tfno_defaults_presets_and_the_flagship_count():
    """TFNO is the FNO with rank-0.1 Tucker weights by default; the port's
    ``TFNO_Medium2d`` builds the flagship-width TFNO the JAX preset builds,
    leaf for leaf: 6,837,841 parameters (59,329 outside the spectral
    weights, 4 x 1,694,628 in them) against the FNO's 69,265,345."""
    small = TFNO((4, 4), 1, 1, 4, device="cpu")
    assert small.fno_blocks.conv_0.spec.kind == "tucker"
    assert small._init_kwargs["factorization"] == "tucker" and small._init_kwargs["rank"] == 0.1
    two = TFNO((4, 4), 1, 1, 4, 2, device="cpu")  # n_layers positionally
    assert two.n_layers == 2 and two._init_kwargs["factorization"] == "tucker"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = get_model({"model": TFNO_Medium2d().to_dict()}, device="meta")
        jmodel = jbase.get_model({"model": JTFNO_Medium2d().to_dict()})
    assert type(model).__name__ == type(jmodel).__name__ == "TFNO"
    assert count_model_params(model) == 6_837_841
    spectral = sum(p.numel() for n, p in model.named_parameters() if ".conv_" in n
                   and ".w_" in n)
    assert spectral == 4 * 1_694_628
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 1, 128, 128), jnp.float32))["params"]
    convert.check_flax_params(shapes, model.state_dict())
    fno = json.loads(METADATA.read_text())
    assert count_model_params(model_from_metadata(fno, device="meta")) == 69_265_345


def test_scan_layers_still_refuses_factorization():
    with pytest.raises(ValueError, match="scan_layers=True does not support: factorization"):
        FNO((4, 4), 1, 1, 4, scan_layers=True, factorization="tucker", device="cpu")
    with pytest.raises(ValueError, match="separable"):
        TFNO((4, 4), 1, 1, 4, scan_layers=True, factorization=None, separable=True,
             device="cpu")


# ------------------------------------------------------- optimizer, files --


def _cfg(policy):
    return SimpleNamespace(learning_rate=1e-2, step_size=1, gamma=0.5, weight_decay=1e-4,
                           opt_state=policy)


def _states(policy, steps=2):
    """JAX TFNO params and optax state after ``steps`` updates, and the
    port's model and AdamW holding the same values."""
    _, params, model = _models(_tfno_meta(), (RES, RES), seed=3)
    tx = jopt.build_optimizer(_cfg(policy), 2)
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    params, opt_state = jax.device_get(params), jax.device_get(opt_state)
    _load(model, params)
    opt = build_optimizer(_cfg(policy), 2).bind(model.named_parameters())
    opt.load_state_dict(fser.to_state_dict(opt_state))
    return params, opt_state, model, opt


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_adamw_state_of_the_factors_after_two_steps_matches_optax(policy):
    """Two steps on the same gradients from the same TFNO weights: the
    factored policy keeps row and column means of the second moment for the
    3-D factor leaves and the 5-D core, as optax does (``p.ndim >= 2``)."""
    _, params, model = _models(_tfno_meta(), (RES, RES), seed=3)
    tx = jopt.build_optimizer(_cfg(policy), 2)
    j_state = tx.init(params)
    opt = build_optimizer(_cfg(policy), 2).bind(model.named_parameters())
    rng = np.random.default_rng(6)
    named = dict(model.named_parameters())
    for _ in range(2):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in named.items()}
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        updates, j_state = tx.update(convert.unflatten_flax(
            {n: jnp.asarray(g) for n, g in grads.items()}), j_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    want_state = convert.flatten_flax(fser.to_state_dict(jax.device_get(j_state)))
    got_state = convert.flatten_flax(opt.state_dict())
    assert set(got_state) == set(want_state)
    core = "0.nu_row.fno_blocks.conv_0.w_core"
    if policy == "factored":  # the core is stored (2, r0, r1, r2, r3), a factor (2, s, r)
        assert got_state[core].ndim == 4
        assert got_state["0.nu_col.fno_blocks.conv_0.w_factor_0"].ndim == 2
    tol = 1e-6 if policy == "full" else 2.0 ** -8
    for name, leaf in got_state.items():
        got, want = _np(torch.as_tensor(leaf)), _np(want_state[name])
        np.testing.assert_allclose(got, want, rtol=tol, atol=1e-9, err_msg=name)
    for name, leaf in convert.flatten_flax(params).items():
        np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(leaf),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_tfno_training_state_crosses_between_the_packages_bit_for_bit(tmp_path, policy):
    params, opt_state, model, opt = _states(policy)
    # JAX-saved files through the port's loaders, and back out byte for byte
    jts.save_training_state(tmp_path / "jax", "model", params, opt_state, epoch=7)
    fresh_model, fresh_opt = _states(policy, steps=0)[2:]
    state, loaded, epoch = tts.load_training_state(
        tmp_path / "jax", "model", fresh_model.state_dict(), fresh_opt.state_dict(),
        device="cpu")
    fresh_model.load_state_dict(state)
    fresh_opt.load_state_dict(loaded)
    assert epoch == 7 and int(fresh_opt.count) == 2
    for name, p in model.state_dict().items():
        assert torch.equal(fresh_model.state_dict()[name], p), name
    tts.save_training_state(tmp_path / "port", "model", fresh_model.state_dict(),
                            fresh_opt.state_dict(), epoch=7)
    for name in ("model.msgpack", "optimizer.msgpack", "manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # port-saved files read by the JAX package, leaf for leaf
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    tx = jopt.build_optimizer(_cfg(policy), 2)
    got_params, got_opt, _ = jts.load_training_state(tmp_path / "port", "model", zeros,
                                                     tx.init(zeros))
    for a, b in zip(jax.tree_util.tree_leaves(got_params), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(got_opt), jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert serialization.msgpack_serialize(convert.to_flax_params(model.state_dict())) == \
        fser.to_bytes(params)


def test_tfno_metadata_and_checkpoints_rebuild_in_both_packages(tmp_path):
    """``save_arch_metadata`` of a port TFNO rebuilds the JAX TFNO through
    the JAX ``from_checkpoint``; the JAX package's ``save_checkpoint`` files
    (metadata and ``{name}_state_dict.msgpack``) rebuild the port's through
    ``from_checkpoint`` and ``load_checkpoint``, leaf for leaf."""
    _, params, model = _models(_tfno_meta(), (RES, RES))
    save_arch_metadata(model, tmp_path, "model")
    jmodel = jbase.from_checkpoint(tmp_path, "model")
    assert type(jmodel).__name__ == "TFNO" and jmodel.factorization == "tucker"
    assert jmodel.rank == 0.1 and jmodel.implementation == "factorized"
    jbase.save_checkpoint(jmodel, {"params": params}, tmp_path, "jax")
    rebuilt = load_checkpoint(from_checkpoint(tmp_path, "jax", device="cpu"), tmp_path, "jax")
    assert isinstance(rebuilt, TFNO)
    flat = convert.flatten_flax(params)
    assert set(rebuilt.state_dict()) == set(flat)
    for name, t in rebuilt.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(flat[name]), err_msg=name)


# ------------------------------------------------- entry points, serving --

TUCKER = ["--model.factorization", "tucker", "--model.rank", "0.1"]


def test_train_navier_stokes_with_tucker_weights_matches_the_jax_script(
        tmp_path, monkeypatch, capsys, jax_main):
    """``--model.factorization tucker --model.rank 0.1`` on both scripts at
    16², 2 epochs from one warm start with saves, then each resumes its own
    run for a third epoch. ``model.msgpack`` rebuilds through
    ``from_checkpoint`` (the FNO class with Tucker weights, as the run
    saved it), ``serve_model`` serves it and exports it, and the artifact
    answers as JAX's ``CompiledForward`` on the same files."""
    data = tmp_path / "data"
    jns.generate_navier_stokes_files(data, n_train=16, n_test=8, res=16, T=0.05, seed=3)
    monkeypatch.setattr(tns, "DATA_ROOT", data)
    args = [*ARGS, *TUCKER]
    config = jax_script_config(args)
    params = jbase.get_model(config.to_dict()).init(
        jax.random.PRNGKey(4), np.zeros((1, 1, 16, 16), np.float32))["params"]
    assert "w_core" in params["fno_blocks"]["conv_0"]
    jts.save_training_state(tmp_path / "init", "best_model", params)
    first = ["--opt.n_epochs", "2", "--warm_start_from", str(tmp_path / "init")]
    want = jax_main([*args, *first, "--save_dir", str(tmp_path / "jax")], data)
    got = tscript.main([*args, *first, "--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert _final(out).startswith("final: {'train_err'")
    _same(got, want)
    resume = ["--opt.n_epochs", "3", "--resume_from_dir"]
    want = jax_main([*args, *resume, str(tmp_path / "jax"), "--save_dir",
                     str(tmp_path / "jax")], data)
    got = tscript.main([*args, *resume, str(tmp_path / "port"), "--save_dir",
                        str(tmp_path / "port"), "--device", "cpu"])
    assert "resuming from" in capsys.readouterr().out
    _same(got, want)
    rebuilt = from_checkpoint(tmp_path / "port", "model", device="cpu")
    assert rebuilt.fno_blocks.conv_0.spec.kind == "tucker"
    state, _, epoch = tts.load_training_state(tmp_path / "port", "model", rebuilt.state_dict(),
                                              device="cpu")
    rebuilt.load_state_dict(state)
    assert epoch == 2

    # serve_model on the saved run: the endpoint answers as JAX's CompiledForward
    result = serve_model.main(["--ckpt_dir", str(tmp_path / "port"), "--name", "model",
                               "--shape", "[1,16,16]", "--buckets", "[1,4]",
                               "--probe_iters", "1", "--device", "cpu",
                               "--export", str(tmp_path / "tfno.pt2")])
    assert result["ragged"]["finite"] and result["ragged"]["shape"] == (3, 1, 16, 16)
    assert result["weight_bytes"] == 4 * count_model_params(rebuilt)
    forward = serving.load_exported(tmp_path / "tfno.pt2")
    jmodel = jbase.from_checkpoint(tmp_path / "port", "model")
    jparams, _, _ = jts.load_training_state(tmp_path / "port", "model", params)
    from neuraloperator_tpu.data.transforms import load_data_processor as jload_dp
    from neuraloperator_tpu_torch.data.transforms import load_data_processor

    dp, jdp = load_data_processor(tmp_path / "port"), jload_dp(tmp_path / "port")
    jserved = jserving.CompiledForward(
        jmodel, jparams, jnp.zeros((1, 1, 16, 16)), batch_sizes=(8,),
        preprocess_fn=jdp.in_normalizer.transform,
        postprocess_fn=jdp.out_normalizer.inverse_transform)
    x = _rand(9, 8, 1, 16, 16)
    got = forward(torch.from_numpy(x))
    assert _rel_l2(got.numpy(), np.asarray(jserved(jnp.asarray(x)))) <= SERVE_TOL
    with torch.no_grad():
        eager = dp.out_normalizer.inverse_transform(
            rebuilt.eval()(dp.in_normalizer.transform(torch.from_numpy(x))))
    assert torch.equal(got, eager)


def test_model_arch_tfno_takes_the_config_factorization_in_both_packages():
    """``--model.model_arch tfno`` names the TFNO class, but the model
    section's ``factorization`` (None) and ``rank`` (1.0) defaults are passed
    to it, so it alone builds dense weights, in JAX as in the port; with the
    two flags it builds what ``--model.factorization tucker --model.rank
    0.1`` builds."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for extra, kind in (([], "dense"), (TUCKER, "tucker")):
            argv = [*ARGS, "--model.model_arch", "tfno", *extra]
            jmodel = jbase.get_model(jax_script_config(argv).to_dict())
            model = get_model(tscript.make_config_from_cli(tscript.NSConfig, argv).to_dict(),
                              device="cpu")
            assert type(model).__name__ == type(jmodel).__name__ == "TFNO"
            assert model.fno_blocks.conv_0.spec.kind == kind == \
                (jmodel.factorization or "dense")
        fno = get_model(tscript.make_config_from_cli(tscript.NSConfig, [*ARGS, *TUCKER])
                        .to_dict(), device="cpu")
    assert fno._init_kwargs == model._init_kwargs
    assert {n: p.shape for n, p in fno.named_parameters()} == \
        {n: p.shape for n, p in model.named_parameters()}


def _int8_pair():
    """A TFNO wide enough that its cores pass the int8 size threshold."""
    meta = _tfno_meta((16, 16), rank=0.5)
    meta["init_kwargs"]["hidden_channels"] = 16
    return _models(meta, (RES, RES))


def test_int8_codes_of_a_tfno_equal_jax_and_it_serves_as_jax_in_f32_and_int8():
    jmodel, params, model = _int8_pair()
    got = serving.quantize_params_int8(model.state_dict())
    want = convert.flatten_flax(jax.tree_util.tree_map(
        lambda x: x, jserving.quantize_params_int8(params),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert set(got) == set(want)
    quantized = {k for k, (_, s) in got.items() if s is not None}
    # the cores pass the threshold at this width, the (2, 16, r) factors do not
    assert {"fno_blocks.conv_0.w_core", "fno_blocks.conv_1.w_core"} <= quantized
    for name, (codes, scale) in got.items():
        j_codes, j_scale = want[name]
        assert (scale is None) == (j_scale is None), name
        if scale is not None:
            np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes), err_msg=name)
            np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale), err_msg=name)
    x = _rand(10, 3, 1, RES, RES)
    for quantize in (None, "int8"):
        served = serving.CompiledForward(model, torch.zeros(1, 1, RES, RES),
                                         batch_sizes=(1, 4), quantize=quantize, device="cpu")
        jserved = jserving.CompiledForward(jmodel, params, jnp.zeros((1, 1, RES, RES)),
                                           batch_sizes=(1, 4), quantize=quantize)
        assert _rel_l2(served(torch.from_numpy(x)).numpy(),
                       np.asarray(jserved(jnp.asarray(x)))) <= SERVE_TOL, quantize


def test_exported_tfno_holds_the_einsums_and_answers_any_batch():
    """The factorized TFNO's artifact: no contraction operator (the
    factors are contracted by einsums), a symbolic batch planned with the
    stand-in size; the reconstructed one calls the operator once per layer."""
    _, _, model = _models(_tfno_meta(), (RES, RES))
    blob = serving.export_forward(model, torch.zeros(2, 1, RES, RES))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert "neuraloperator_tpu_torch.mode_contraction.default" not in targets
    forward = serving.load_exported(blob)
    for n in (1, 3, 8):
        x = torch.from_numpy(_rand(n, n, 1, RES, RES))
        with torch.no_grad():
            got, want = forward(x), model.eval()(x)
        assert torch.equal(got, want) if n == 8 else _rel_l2(got, want) <= 1e-6
    recon = _load(model_from_metadata(_tfno_meta(implementation="reconstructed"), device="cpu"),
                  convert.to_flax_params(model.state_dict()))
    program = torch.export.load(io.BytesIO(serving.export_forward(recon,
                                                                  torch.zeros(2, 1, RES, RES))))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("neuraloperator_tpu_torch.mode_contraction.default") == 2
