"""The recipes' optimizer options in the port against the JAX package's.

The int8 first moment (``factored8``: ``quantize_blockwise`` and the int8
branch of the factored Adam), ``cast_final_updates=False``, stochastic
rounding into bf16 master weights, and the EMA of the parameters, each on
the CPU against ``neuraloperator_tpu.training.optimizer`` and optax, with
inputs drawn from numpy seeds; then ``optimizer.msgpack`` of each state
against the JAX package's file, and ``train_navier_stokes`` with each
option at a tiny width.

Tolerances:
* blockwise quantization: codes and scales equal to the bit (the same f32
  operations in the same order, half-to-even rounding on both sides);
* factored8 AdamW over 5 steps across a ``step_lr`` boundary: the int8
  codes, the block scales and the bf16 first moments of small leaves equal
  to the bit, the parameters ``rtol=1e-6, atol=1e-9`` (the full policy's
  bound in ``test_torch_optimizer.py``: the f32 update in optax's order);
* ``cast_final_updates=False`` on a bf16 parameter: equal to the bit
  (elementwise ops with the same roundings); the EMA over 5 steps with
  ``lr_scale`` 0.3: the parameters' bound, ``rtol=1e-6, atol=1e-9`` (it
  folds in parameters that may sit an f32 ulp apart);
* stochastic rounding given JAX's noise bits: equal to the bit; the mean of
  4096 draws within 4 standard errors of x; the share rounded up within 4
  standard errors of the discarded fraction;
* ``optimizer.msgpack``: byte for byte the JAX package's file, read back by
  either package bit for bit;
* the entry point: factored8 and EMA runs against the JAX script, each
  final metric and the ``ema:`` metrics within ``rtol=1e-5`` (the same f32
  steps, sums in another order); the stochastic-rounding run draws other
  noise than JAX, so it is held to finite metrics, bf16 parameters, and
  within 5% of the JAX run's metrics.
"""

import functools
import importlib.util
import re
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

from neuraloperator_tpu.data.datasets import navier_stokes as jns
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert, serialization
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript
from neuraloperator_tpu_torch.training import Trainer, build_optimizer
from neuraloperator_tpu_torch.training import optimizer as topt
from neuraloperator_tpu_torch.training import training_state as tts
from test_torch_optimizer import SHAPES, STEPS_PER_EPOCH, _run_both, _schedule
from test_torch_trainer import _both, _pairs, _processors

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16) if np.asarray(a).dtype.itemsize == 2 \
        else np.asarray(a).view(np.uint32)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).numpy().view(np.uint16)


# -------------------------------------------------------------- factored8 --


@pytest.mark.parametrize("size,zero_block", [(5000, False), (2048, False), (4096 + 7, True),
                                             (13, False)])
def test_blockwise_quantization_is_the_jax_codes_to_the_bit(size, zero_block):
    """Sizes that pad the last block (5000, 4103, 13) and one that does not,
    with an all-zero block (scale 0, codes 0) in one of them."""
    x = np.random.default_rng(size).standard_normal(size).astype(np.float32) * 3e-3
    if zero_block:
        x[2048:4096] = 0.0
    want = jopt.quantize_blockwise(jnp.asarray(x))
    got = topt.quantize_blockwise(torch.from_numpy(x))
    assert got.codes.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.codes.shape) == want.codes.shape and tuple(got.scale.shape) == \
        want.scale.shape
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(_bits(got.scale.numpy()), _bits(want.scale))
    if zero_block:
        assert float(got.scale[1]) == 0.0 and not got.codes[1].any()
    shape = (size,)
    np.testing.assert_array_equal(
        topt.dequantize_blockwise(got, shape).numpy(),
        np.asarray(jopt.dequantize_blockwise(want, shape)))


@pytest.mark.parametrize("lr_scale", [1.0, 0.3])
def test_adamw_factored8_matches_optax(lr_scale):
    """Five steps across the schedule's boundaries: int8 codes and scales
    for the leaves of two or more dims, bf16 first moments below."""
    cfg = SimpleNamespace(**_schedule(), opt_state="factored8")
    history, opt, j_state = _run_both(
        jopt.build_optimizer(cfg, STEPS_PER_EPOCH),
        topt.build_optimizer(cfg, STEPS_PER_EPOCH), n_steps=5, lr_scale=lr_scale,
    )
    assert opt.mu_int8 and opt.factored and int(opt.count) == 5
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
    mu = convert.flatten_flax(j_state[0].mu)
    for k, p in zip(SHAPES, opt.param_groups[0]["params"]):
        st = opt.state[p]
        if len(SHAPES[k]) >= 2:
            assert isinstance(mu[k], jopt.Quantized8)
            np.testing.assert_array_equal(st["mu_codes"].numpy(), np.asarray(mu[k].codes))
            np.testing.assert_array_equal(_bits(st["mu_scale"].numpy()), _bits(mu[k].scale))
        else:
            assert st["mu"].dtype == torch.bfloat16 and mu[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bf16_np(st["mu"]), _bits(mu[k]))


def test_int8_first_moment_needs_the_factored_path():
    with pytest.raises(ValueError, match="factored_second_moment=True"):
        jopt.adamw(1e-3, mu_dtype="int8")
    with pytest.raises(ValueError, match="factored_second_moment=True"):
        topt.adamw(1e-3, mu_dtype="int8")


# ------------------------------------------ cast_final_updates, SR rounding --


def test_uncast_updates_on_a_bf16_parameter_match_optax():
    """``cast_final_updates=False``: the f32 update meets the bf16 parameter
    in optax.apply_updates (the sum in f32, rounded to bf16 once)."""
    rng = np.random.default_rng(7)
    init = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    kw = dict(weight_decay=0.1, factored_second_moment=True, mu_dtype=None,
              cast_final_updates=False)
    tx = jopt.adamw(1e-2, **kw)
    j_params = {"w": jnp.asarray(init).astype(jnp.bfloat16)}
    j_state = tx.init(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), j_params))
    param = torch.nn.Parameter(torch.from_numpy(init).bfloat16())
    opt = topt.adamw(1e-2, **kw).bind([("w", param)])
    for g in grads:
        gb = jnp.asarray(g).astype(jnp.bfloat16)
        updates, j_state = tx.update({"w": gb}, j_state, j_params)
        assert updates["w"].dtype == jnp.float32
        j_params = optax.apply_updates(j_params, updates)
        param.grad = torch.from_numpy(np.asarray(gb.astype(jnp.float32))).bfloat16()
        opt.step()
    assert param.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_np(param), _bits(j_params["w"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_stochastic_rounding_is_jax_to_the_bit_given_its_noise(seed):
    """The port's rounding core fed the bits ``jax.random.bits(key, shape,
    uint16)`` draws for ``stochastic_round_to``: every rounded value equals
    JAX's, across signs, magnitudes, exact bf16 values and zero."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4099) * 10.0 ** rng.integers(-6, 4, 4099)).astype(np.float32)
    x[:5] = [0.0, -0.0, 1.0, -1.5, 3.0e38]
    key = jax.random.PRNGKey(seed)
    want = jopt.stochastic_round_to(jnp.bfloat16, jnp.asarray(x), key)
    noise = np.asarray(jax.random.bits(key, x.shape, jnp.uint16)).astype(np.int32)
    got = topt.round_bf16_with_noise(torch.from_numpy(x), torch.from_numpy(noise))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_np(got), _bits(want))


def test_stochastic_rounding_is_unbiased_and_rounds_up_by_the_discarded_fraction():
    """x = 1 + 3 * 2**-10 lies 3/8 of the way from bf16 1.0 to the next
    value (ulp 2**-7): 4096 draws round up with probability 3/8, and their
    mean is x."""
    gen = torch.Generator().manual_seed(3)
    x = 1.0 + 3 * 2.0 ** -10
    draws = topt.stochastic_round_to(torch.bfloat16, torch.full((4096,), x), gen).double()
    lo, hi = 1.0, 1.0 + 2.0 ** -7
    assert set(draws.unique().tolist()) == {lo, hi}
    up, frac = float((draws == hi).double().mean()), (x - lo) / (hi - lo)
    assert abs(up - frac) <= 4 * (frac * (1 - frac) / 4096) ** 0.5
    sigma = (hi - lo) * (frac * (1 - frac)) ** 0.5 / 4096 ** 0.5
    assert abs(float(draws.mean()) - x) <= 4 * sigma
    with pytest.raises(NotImplementedError, match="bfloat16"):
        topt.stochastic_round_to(torch.float16, torch.ones(2), gen)


def test_apply_updates_sr_rounds_bf16_leaves_and_adds_the_others():
    """bf16 leaves: the f32 sum rounded stochastically (up or down, never
    further); f32 leaves: the plain sum; a bf16 update to a bf16 leaf warns
    with the JAX package's message."""
    gen = torch.Generator().manual_seed(0)
    p16 = torch.full((1000,), 1.0).bfloat16()
    p32 = torch.full((3,), 2.0)
    topt.apply_updates_sr([p16, p32], [torch.full((1000,), 2.0 ** -9), torch.ones(3)], gen)
    assert set(p16.float().unique().tolist()) == {1.0, 1.0 + 2.0 ** -7}
    assert torch.equal(p32, torch.full((3,), 3.0))
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        jopt.apply_updates_sr({"w": jnp.ones(2, jnp.bfloat16)}, {"w": jnp.ones(2, jnp.bfloat16)},
                              jax.random.PRNGKey(0))
    with pytest.warns(UserWarning) as port_warned:
        topt.apply_updates_sr([p16[:2]], [torch.ones(2).bfloat16()], gen)
    assert str(port_warned[0].message) == str(jax_warned[0].message)


def test_trainer_with_stochastic_rounding_keeps_bf16_masters_and_f32_state():
    """The JAX Trainer's SR: every f32 parameter becomes a bf16 master, the
    optimizer state is built from the f32-promoted parameters, the updates
    stay f32 (``build_optimizer`` turns the final cast off); an optimizer
    that casts them warns as the JAX package does."""
    _, _, model = _both()
    x, y = _pairs(0, 8)
    dp, _ = _processors(x, y)
    trainer = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu",
                      stochastic_rounding=True)
    assert trainer.sr_generator is not None and trainer.sr_generator.initial_seed() == 0x5757
    before = {n: p.detach().bfloat16() for n, p in model.named_parameters()}
    cfg = SimpleNamespace(learning_rate=1e-3, step_size=10, gamma=0.5, weight_decay=1e-4,
                          opt_state="factored", stochastic_rounding=True)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        metrics = trainer.train(DataLoader(TensorDataset(x, y), 4), {},
                                build_optimizer(cfg, 2), training_loss=H1Loss(d=2))
    # no warning: the updates reach the rounding in f32
    assert not [w for w in warned if "cast_final_updates" in str(w.message)]
    assert np.isfinite(metrics["train_err"])
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert not trainer.optimizer.cast_final_updates
    for name, p in model.named_parameters():
        state = trainer.optimizer.state[p]
        assert all(v.dtype == torch.float32 for k, v in state.items() if k != "mu"), name
        assert state["mu"].dtype == torch.bfloat16  # "factored": bf16 mu, as in JAX
    assert any(not torch.equal(p.detach(), before[n]) for n, p in model.named_parameters())
    cast = SimpleNamespace(**{**vars(cfg), "stochastic_rounding": False})
    with pytest.warns(UserWarning, match="cast_final_updates=False"):
        trainer.train(DataLoader(TensorDataset(x, y), 4), {}, build_optimizer(cast, 2),
                      training_loss=H1Loss(d=2))


# --------------------------------------------------------------------- EMA --


@pytest.mark.parametrize("policy", ["full", "factored8"])
def test_ema_matches_jax_with_a_scheduler_factor(policy):
    """``with_ema`` over 5 steps with ``lr_scale`` 0.3: the EMA folds in the
    parameters given to each update (before it, and before the factor),
    as the JAX wrapper does; it starts at the bound parameters."""
    cfg = SimpleNamespace(**_schedule(), opt_state=policy)
    history, opt, j_state = _run_both(
        jopt.with_ema(jopt.build_optimizer(cfg, STEPS_PER_EPOCH), decay=0.9),
        topt.with_ema(topt.build_optimizer(cfg, STEPS_PER_EPOCH), decay=0.9),
        n_steps=5, lr_scale=0.3,
    )
    assert isinstance(j_state, jopt.EmaState)
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
    want = {k: np.asarray(v) for k, v in convert.flatten_flax(jopt.ema_params(j_state)).items()}
    opt.names = list(SHAPES)
    got = topt.ema_params(opt)
    for k in SHAPES:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    with pytest.raises(TypeError, match="with_ema"):
        topt.ema_params(topt.build_optimizer(cfg, 2).bind([torch.zeros(2)]))


# ------------------------------------------------------------ checkpoints --


def _cfg(policy, ema):
    return SimpleNamespace(learning_rate=1e-2, step_size=1, gamma=0.5, weight_decay=1e-4,
                           opt_state=policy, ema_decay=ema)


def _states(policy, ema, steps=2):
    """JAX params and optax state after ``steps`` updates, and the port's
    model and AdamW holding the same values."""
    _, params, model = _both(seed=3)
    tx = jopt.build_optimizer(_cfg(policy, ema), 2)
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    params, opt_state = jax.device_get(params), jax.device_get(opt_state)
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    opt = topt.build_optimizer(_cfg(policy, ema), 2).bind(model.named_parameters())
    opt.load_state_dict(fser.to_state_dict(opt_state))
    return params, opt_state, model, opt


@pytest.mark.parametrize("policy,ema", [("factored8", 0.0), ("factored", 0.99),
                                        ("factored8", 0.99), ("full", 0.99)])
def test_optimizer_msgpack_is_the_jax_file_in_both_directions(tmp_path, policy, ema):
    params, opt_state, model, opt = _states(policy, ema)
    assert serialization.msgpack_serialize(opt.state_dict()) == fser.to_bytes(opt_state)
    # the JAX package's files restore into a fresh port optimizer, and back
    jts.save_training_state(tmp_path / "jax", "model", params, opt_state, epoch=7)
    fresh_model, fresh_opt = _states(policy, ema, steps=0)[2:]
    state, loaded, epoch = tts.load_training_state(
        tmp_path / "jax", "model", fresh_model.state_dict(), fresh_opt.state_dict(),
        device="cpu")
    fresh_opt.load_state_dict(loaded)
    assert epoch == 7 and int(fresh_opt.count) == 2
    tts.save_training_state(tmp_path / "port", "model", state, fresh_opt.state_dict(),
                            epoch=7)
    for name in ("model.msgpack", "optimizer.msgpack"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    tx = jopt.build_optimizer(_cfg(policy, ema), 2)
    _, got_opt, _ = jts.load_training_state(tmp_path / "port", "model", zeros, tx.init(zeros))
    assert jax.tree_util.tree_structure(got_opt) == jax.tree_util.tree_structure(opt_state)
    for a, b in zip(jax.tree_util.tree_leaves(got_opt), jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(_bits(a) if a.dtype.itemsize in (2, 4) else a,
                                      _bits(b) if b.dtype.itemsize in (2, 4) else b)


def test_a_state_of_another_option_is_refused():
    _, _, model, with_ema = _states("factored8", 0.99, steps=1)
    plain = topt.build_optimizer(_cfg("factored8", 0.0), 2).bind(model.named_parameters())
    with pytest.raises(ValueError, match="EMA"):
        plain.load_state_dict(with_ema.state_dict())
    with pytest.raises(ValueError, match="EMA"):
        with_ema.load_state_dict(plain.state_dict())
    bf16_mu = topt.build_optimizer(_cfg("factored", 0.99), 2).bind(model.named_parameters())
    with pytest.raises(ValueError, match="mu"):
        bf16_mu.load_state_dict(with_ema.state_dict())


# -------------------------------------------------------- the entry point --

ARGS = [
    "--data.n_train", "16", "--data.train_resolution", "16", "--data.n_tests", "[8]",
    "--data.test_resolutions", "[16]", "--data.test_batch_sizes", "[4]",
    "--data.batch_size", "4", "--model.n_modes", "[4,4]", "--model.hidden_channels", "8",
    "--model.n_layers", "2", "--opt.learning_rate", "1e-3", "--opt.step_size", "1",
    "--opt.opt_state", "factored", "--opt.training_loss", "h1", "--device_dataset", "true",
    "--eval_interval", "1", "--opt.n_epochs", "2",
]
OPTIONS = {"factored8": ["--opt.opt_state", "factored8"],
           "ema": ["--opt.ema_decay", "0.9"],
           "sr": ["--opt.stochastic_rounding", "true"]}


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_navier_stokes",
                                                  ROOT / "scripts/train_navier_stokes.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(out: str, label: str) -> dict:
    import ast

    return ast.literal_eval(re.findall(rf"^{label}: (.*)$", out, re.M)[-1])


@pytest.mark.parametrize("option", list(OPTIONS))
def test_the_entry_point_runs_each_option_as_jax_does(tmp_path, monkeypatch, capsys, option):
    data = tmp_path / "data"
    jns.generate_navier_stokes_files(data, n_train=16, n_test=8, res=16, T=0.05, seed=3)
    monkeypatch.setattr(tns, "DATA_ROOT", data)
    module = _jax_script()
    monkeypatch.setattr(module, "load_navier_stokes_pt",
                        functools.partial(jns.load_navier_stokes_pt, data_root=data))
    from neuraloperator_tpu.config import make_config_from_cli
    from neuraloperator_tpu.models import get_model

    argv = [*ARGS, *OPTIONS[option]]
    config = make_config_from_cli(module.NSConfig, list(argv))
    params = get_model(config.to_dict()).init(jax.random.PRNGKey(4),
                                              np.zeros((1, 1, 16, 16), np.float32))["params"]
    jts.save_training_state(tmp_path / "init", "best_model", params)
    # the EMA starts at the weights the optimizer state is built from, those
    # of the model before the warm start (the JAX Trainer's init, key 0): the
    # port's model starts from the same ones
    init = get_model(config.to_dict()).init(jax.random.PRNGKey(0),
                                            np.zeros((4, 1, 16, 16), np.float32))["params"]
    port_get_model = tscript.get_model

    def get_model_at_the_jax_init(cfg, device):
        model = port_get_model(cfg, device=device)
        model.load_state_dict(convert.convert_flax_params(init, model.state_dict(), device))
        return model

    monkeypatch.setattr(tscript, "get_model", get_model_at_the_jax_init)
    argv += ["--warm_start_from", str(tmp_path / "init"), "--save_dir"]
    precision = jax.config.jax_default_matmul_precision
    monkeypatch.setattr(sys, "argv", ["train_navier_stokes.py", *argv, str(tmp_path / "jax")])
    try:
        want = module.main()
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
    jax_out = capsys.readouterr().out
    got = tscript.main([*argv, str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(got) == set(want)
    tol = 5e-2 if option == "sr" else 1e-5
    for k in ("train_err", "16_h1", "16_l2"):
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)
    if option == "ema":
        got_ema, want_ema = _printed(out, "ema"), _printed(jax_out, "ema")
        assert set(got_ema) == set(want_ema) == {"16_h1", "16_l2"}
        for k in got_ema:
            np.testing.assert_allclose(got_ema[k], want_ema[k], rtol=tol, err_msg=k)
    # the saved optimizer state reads back into the JAX package's template
    saved = serialization.read_msgpack(tmp_path / "port" / "optimizer.msgpack")
    want_saved = serialization.read_msgpack(tmp_path / "jax" / "optimizer.msgpack")
    assert _keys(saved) == _keys(want_saved)
    if option == "sr":
        weights = serialization.read_msgpack(tmp_path / "port" / "model.msgpack")
        assert {str(v.dtype) for v in convert.flatten_flax(weights).values()} == \
            {"torch.bfloat16"}


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return {k for key, v in tree.items() for k in _keys(v, f"{prefix}{key}/")} | {prefix}
    return {prefix}
