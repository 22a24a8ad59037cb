"""The port's mixed-precision policy against the JAX package's, on the CPU.

Small sizes throughout (16² grids, width 8, 2 layers, 8x8 modes). The
same numpy inputs and the same parameters (through ``convert``) go to both
packages. The JAX side reaches the contraction two ways:

* the XLA packed einsum (``set_contraction_backend("xla")``): exact bf16
  products summed in f32, the arithmetic of the port's kernel and of its
  plain version;
* the Pallas kernel in interpret mode, whose Karatsuba form also rounds
  ``ar + ai`` and ``br + bi`` to bf16 (ROADMAP §C).

XLA under ``jit`` keeps bf16 chains in f32 between ops (excess precision):
jitted JAX departs from its own eager forward by 1e-2 on the mixed FNO.
The port rounds after every op, as eager JAX does, so a comparison that
must show the rounding points runs JAX eagerly (``jax.disable_jit``).

Tolerances:
* the DFT helpers, ``SpectralConv`` under "mixed"/"half" (both weight
  dtypes) and the whole FNO under the half policy, against eager JAX with
  the XLA contraction: relative l2 <= 1e-6. They agree to the bit here;
  the bound admits a tie rounded the other way, not a rounding point
  moved (one moved shifts the result by some 1e-3);
* the same forwards against the Pallas contraction: <= 1e-2 (4.3e-3
  measured for the layer, 7.5e-3 for the FNO); a "mixed" FNO on f32
  parameters and inputs: <= 4e-3 (f32 sums in another order flip bf16
  roundings downstream);
* one mixed ``Trainer`` step against eager JAX (XLA contraction, ``optax``):
  the loss within 1e-5 relative (1.2e-7 measured); all gradients together
  within relative l2 1e-2 (3.5e-3 measured), each leaf within 5e-2 of
  the larger of its own norm and 1% of the whole gradient's (the biases'
  gradients are sums that cancel, and XLA reduces them in bf16 where the
  port sums in f32); the step's updates together within relative l2 0.15
  (0.09 measured): the first Adam step is about ``lr * sign(g)``, so a
  gradient near zero flips sign on a bf16 rounding, and a bf16 weight
  moves by a whole ulp or not at all;
* the mixed evaluation (``eval_ns_checkpoint.evaluate``) against the JAX
  Trainer's mixed eval step, eager: 1e-6 relative;
* a 2-epoch mixed run (staged set and loader loop) against jitted JAX:
  each metric within 1e-3 relative (8.1e-5 measured);
* a bf16 parameter through the optimizer (both policies, three steps)
  against optax: equal to the bit;
* ``CompiledForward(param_dtype=bf16)`` on f32 requests (f32 arithmetic over
  bf16 weights) against the JAX class: 1e-5; a "mixed" bf16-weight model on
  bf16 requests against the eager forward of the same weights: 1e-6, and
  against the (jitted) JAX class: 2e-2;
* a mixed run's checkpoint: byte-identical to the JAX package's file for
  the same params and optimizer state, and read back by JAX bit for bit;
* ``train_navier_stokes`` with the mixed flags against the JAX script
  (``tests/test_torch_train_script.py``): each final metric within 1e-3
  relative (1.8e-4 measured).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser
from jax.experimental import pallas as pl

from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.layers import spectral_convolution as jconv
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.ops import fourier as jf
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu.serving import CompiledForward as JCompiledForward
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert, serialization
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.layers import SpectralConv
from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
from neuraloperator_tpu_torch.models import model_from_metadata
from neuraloperator_tpu_torch.ops import fourier as tf
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
from neuraloperator_tpu_torch.serving import CompiledForward
from neuraloperator_tpu_torch.training import Trainer, build_optimizer, setup
from neuraloperator_tpu_torch.training.trainer import half_precision_forward
from test_torch_trainer import RES, _capture_grads, _jax_model, _meta, _opt_cfg, _pairs
from test_torch_trainer import _processors, _rel_l2

torch.set_num_threads(1)

EXACT = 1e-6
PALLAS_TOL = 1e-2
MIXED = dict(weight_dtype="bfloat16", fno_block_precision="mixed")


@pytest.fixture
def jax_xla():
    set_contraction_backend("xla")
    yield
    set_contraction_backend("auto")


def _np(a) -> np.ndarray:
    """A tensor or JAX array as float32 numpy (bf16 values exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(seed, *shape):
    rng = np.random.default_rng(seed)
    t = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
         for _ in range(2)]
    return t, [jnp.asarray(_np(a)).astype(jnp.bfloat16) for a in t]


def _models(**overrides):
    """The JAX model with its params and the port model holding the same values."""
    meta = _meta()
    meta["init_kwargs"].update(overrides)
    jmodel = _jax_model(meta)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, RES, RES)))["params"]
    model = model_from_metadata(meta, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, jax.device_get(params), model


def _fresh(params_np):
    """A copy of the JAX params: a jitted train step donates what it is given."""
    return jax.tree_util.tree_map(jnp.array, params_np)


# ---------------------------------------------------------------- forward --


@pytest.mark.parametrize("helper", ["rdft_gather_last", "dft_gather_axis", "dft_scatter_axis",
                                    "rdft_scatter_last"])
def test_dft_helpers_in_bf16_match_jax(helper):
    (xr, xi), (jr, ji) = _bf16_pair(0, 2, 8, 16, 5)
    if helper == "rdft_gather_last":
        (x, _), (jx, _) = _bf16_pair(1, 2, 8, 16, 16)
        got, want = tf.rdft_gather_last(x, 5, "forward"), jf.rdft_gather_last(jx, 5, "forward")
    elif helper == "dft_gather_axis":
        got = tf.dft_gather_axis(xr, xi, 8, -2, "forward")
        want = jf.dft_gather_axis(jr, ji, 8, -2, "forward")
    elif helper == "dft_scatter_axis":
        got = tf.dft_scatter_axis(xr, xi, 16, -2, "forward")
        want = jf.dft_scatter_axis(jr, ji, 16, -2, "forward")
    else:  # the f32 sum of two f32-accumulated products
        got = (tf.rdft_scatter_last(xr, xi, 16, "forward"),)
        want = (jf.rdft_scatter_last(jr, ji, 16, "forward"),)
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert _rel_l2(_np(g), _np(w)) <= EXACT


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["mixed", "half"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_spectral_conv_mixed_and_half_match_jax(monkeypatch, backend, precision, weight_dtype):
    if backend == "pallas":
        monkeypatch.setattr(pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend(backend)
    try:
        x = np.random.default_rng(2).standard_normal((2, 6, 16, 16)).astype(np.float32)
        kw = dict(fno_block_precision=precision, weight_dtype=weight_dtype)
        jmodule = jconv.SpectralConv(6, 10, (8, 8), **kw)
        variables = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))
        port = SpectralConv(6, 10, (8, 8), device="cpu", **kw)
        port.load_state_dict(convert.convert_flax_params(variables["params"],
                                                         port.state_dict(), device="cpu"))
        want = jmodule.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    finally:
        set_contraction_backend("auto")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert port.w_weight.dtype == {"float32": torch.float32,
                                   "bfloat16": torch.bfloat16}[weight_dtype]
    assert _rel_l2(_np(got), _np(want)) <= (EXACT if backend == "xla" else PALLAS_TOL)


@pytest.mark.parametrize("backend,precision", [("xla", "mixed"), ("xla", "half"),
                                               ("pallas", "mixed")])
def test_fno_under_the_half_policy_matches_jax(monkeypatch, backend, precision):
    if backend == "pallas":
        monkeypatch.setattr(pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend(backend)
    try:
        jmodel, params, model = _models(weight_dtype="bfloat16", fno_block_precision=precision)
        x, _ = _pairs(2, 3)
        half_params, half_kwargs = jtrainer.Trainer._half_policy(None, params,
                                                                 {"x": jnp.asarray(x)})
        want = jmodel.apply({"params": half_params}, **half_kwargs)
        with torch.no_grad():
            got = half_precision_forward(model, {"x": torch.from_numpy(x)})
    finally:
        set_contraction_backend("auto")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the master parameters are untouched by the policy
    assert {p.dtype for n, p in model.named_parameters() if "w_weight" not in n} == \
        {torch.float32}
    assert _rel_l2(_np(got), _np(want)) <= (EXACT if backend == "xla" else PALLAS_TOL)


@pytest.mark.parametrize("n_modes,res", [((8,), (32,)), ((4, 4, 4), (8, 9, 10))],
                         ids=["1d", "3d"])
def test_fno_under_the_half_policy_matches_jax_in_1d_and_3d(jax_xla, n_modes, res):
    """The mixed FNO under the half policy on a 1-D grid of 32 points and a
    3-D grid of 8x9x10, against eager JAX with the XLA contraction: equal
    to the bit, as a CPU probe of both packages found it."""
    meta = _meta()
    meta["init_kwargs"].update(n_modes=list(n_modes), **MIXED)
    jmodel = _jax_model(meta)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, *res)))["params"]
    model = model_from_metadata(meta, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    x = np.random.default_rng(4).standard_normal((2, 1, *res)).astype(np.float32)
    half_params, half_kwargs = jtrainer.Trainer._half_policy(None, params, {"x": jnp.asarray(x)})
    want = jmodel.apply({"params": half_params}, **half_kwargs)
    with torch.no_grad():
        got = half_precision_forward(model, {"x": torch.from_numpy(x)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert tuple(got.shape) == want.shape == (2, 1, *res)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_mixed_model_on_f32_inputs_promotes_as_jax(jax_xla):
    """Without the half policy: f32 parameters and inputs around "mixed" blocks.
    The blocks return bf16, and the f32 skips and MLPs promote it back. f32
    sums ordered otherwise than XLA's (1e-7) flip some bf16 roundings of the
    next block's input, so this is held at 4e-3 (2**-8); 3.5e-4 measured."""
    jmodel, params, model = _models(**MIXED)
    x, _ = _pairs(3, 2)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel_l2(_np(got), _np(want)) <= 4e-3


# ---------------------------------------------------------------- training --


def _grad_errors(got: dict, want: dict):
    """Relative l2 of all leaves together, and each leaf's error relative to
    the larger of its norm and 1% of the whole gradient's."""
    names = sorted(want)
    g = np.concatenate([got[n].ravel() for n in names])
    w = np.concatenate([want[n].ravel() for n in names])
    floor = 1e-2 * np.linalg.norm(w)
    per_leaf = {n: float(np.linalg.norm(got[n] - want[n])
                         / max(np.linalg.norm(want[n]), floor)) for n in names}
    return _rel_l2(g, w), per_leaf


@pytest.mark.parametrize("weight_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["full", "factored"])
def test_one_mixed_trainer_step_matches_jax(jax_xla, policy, weight_dtype):
    jmodel, params, model = _models(weight_dtype=weight_dtype, fno_block_precision="mixed")
    x, y = _pairs(2, 4)
    dp, jdp_ = _processors(x, y)
    before = {k: _np(v) for k, v in convert.flatten_flax(params).items()}
    loader = jds.DataLoader(jds.TensorDataset(x, y), 4)

    with jax.disable_jit():  # eager: every op rounded, as in the port
        grab = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_,
                                mixed_precision=True)
        grab.params = _fresh(params)
        j_metrics = grab.train(loader, {}, _capture_grads(), training_loss=jl.H1Loss(d=2))
        upd = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_,
                               mixed_precision=True)
        upd.params = _fresh(params)
        upd.train(loader, {}, jopt.build_optimizer(_opt_cfg(policy), 1),
                  training_loss=jl.H1Loss(d=2))
    j_grads = {k: _np(v) for k, v in convert.flatten_flax(grab.opt_state).items()}
    j_after = {k: _np(v) for k, v in convert.flatten_flax(upd.params).items()}

    trainer = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu",
                      mixed_precision=True)
    metrics = trainer.train(DataLoader(TensorDataset(x, y), 4), {},
                            build_optimizer(_opt_cfg(policy), 1), training_loss=H1Loss(d=2))
    named = dict(model.named_parameters())
    assert set(named) == set(j_grads) == set(j_after)
    # the gradient lands on each parameter in its own dtype, as in JAX
    for name, p in named.items():
        assert p.dtype == p.grad.dtype
        assert str(p.dtype).replace("torch.", "") == str(convert.flatten_flax(upd.params)[name]
                                                          .dtype)
    assert abs(metrics["train_err"] - j_metrics["train_err"]) <= 1e-5 * j_metrics["train_err"]
    total, per_leaf = _grad_errors({n: _np(p.grad) for n, p in named.items()}, j_grads)
    assert total <= 1e-2
    assert max(per_leaf.values()) <= 5e-2, per_leaf
    got_u = np.concatenate([_np(named[n]).ravel() - before[n].ravel() for n in sorted(named)])
    want_u = np.concatenate([j_after[n].ravel() - before[n].ravel() for n in sorted(named)])
    assert _rel_l2(got_u, want_u) <= 0.15


@pytest.mark.parametrize("staged", [True, False], ids=["device_dataset", "loader"])
def test_two_mixed_epochs_match_jax(jax_xla, staged):
    jmodel, params, model = _models(**MIXED)
    x, y = _pairs(5, 24)
    dp, jdp_ = _processors(x[:16], y[:16])
    h1, l2 = (H1Loss(d=2), jl.H1Loss(d=2)), (LpLoss(d=2), jl.LpLoss(d=2))
    ref = jtrainer.Trainer(model=jmodel, n_epochs=2, data_processor=jdp_, mixed_precision=True)
    ref.params = _fresh(params)
    want = ref.train(
        jds.DataLoader(jds.TensorDataset(x[:16], y[:16]), 4, shuffle=True, seed=5),
        {RES: jds.DataLoader(jds.TensorDataset(x[16:], y[16:]), 4)},
        jopt.build_optimizer(_opt_cfg("factored"), 4), training_loss=h1[1],
        eval_losses={"h1": h1[1], "l2": l2[1]}, device_dataset=staged,
    )
    trainer = Trainer(model=model, n_epochs=2, data_processor=dp, device="cpu",
                      mixed_precision=True)
    got = trainer.train(
        DataLoader(TensorDataset(x[:16], y[:16]), 4, shuffle=True, seed=5),
        {RES: DataLoader(TensorDataset(x[16:], y[16:]), 4)},
        build_optimizer(_opt_cfg("factored"), 4), training_loss=h1[0],
        eval_losses={"h1": h1[0], "l2": l2[0]}, device_dataset=staged,
    )
    assert (trainer.staged_step is not None) == staged
    assert model.fno_blocks.conv_0.w_weight.dtype == torch.bfloat16
    assert set(got) == set(want) == {"train_err", "epoch_time", "16_h1", "16_l2"}
    for k in ("train_err", "16_h1", "16_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_mixed_evaluation_matches_the_jax_eval_step(jax_xla):
    """``eval_ns_checkpoint.evaluate(mixed_precision=True)`` against the JAX
    ``Trainer(mixed_precision=True)``'s eval step (eager) and ``evaluate``:
    the same forwards to the bit, then each loss summed in another grouping
    (mean per batch times its length, against sums), so 1e-6 relative."""
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev

    jmodel, params, model = _models(**MIXED)
    x, y = _pairs(6, 8)
    dp, jdp_ = _processors(x, y)
    got = ev.evaluate(model, dp, x, y, 4, device="cpu", mixed_precision=True)
    with jax.disable_jit():
        ref = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_,
                               mixed_precision=True)
        ref.params = _fresh(params)
        step = ref._build_eval_step({"l2": jl.LpLoss(d=2), "h1": jl.H1Loss(d=2)})
        want = ref.evaluate(step, jds.DataLoader(jds.TensorDataset(x, y), 4), "16")
    assert got["pairs"] == 8
    for k in ("l2", "h1"):
        assert abs(got[f"rel_{k}"] - want[f"16_{k}"]) <= 1e-6 * want[f"16_{k}"], (got, want)


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_bf16_parameter_optimizer_state_and_updates_match_optax(policy):
    """A bf16 parameter: the state is built from its f32 promotion (f32 first
    moment under "full", bf16 under "factored"; f32 second moments), the
    update is cast to bf16 and added in bf16, as the JAX Trainer runs optax.
    Three steps of bf16 gradients, elementwise ops on both sides with the
    same roundings (the constants rounded to bf16 as JAX rounds a Python
    scalar): equal to the bit."""
    rng = np.random.default_rng(7)
    init = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    tx = jopt.build_optimizer(SimpleNamespace(learning_rate=1e-2, step_size=10, gamma=0.5,
                                              weight_decay=0.1, opt_state=policy))
    j_params = {"w": jnp.asarray(init).astype(jnp.bfloat16)}
    j_state = tx.init(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), j_params))
    param = torch.nn.Parameter(torch.from_numpy(init).bfloat16())
    opt = build_optimizer(SimpleNamespace(learning_rate=1e-2, step_size=10, gamma=0.5,
                                          weight_decay=0.1, opt_state=policy)
                          ).bind([("w", param)])
    assert opt.state[param]["mu"].dtype == (torch.float32 if policy == "full"
                                            else torch.bfloat16)
    for g in grads:
        gb = jnp.asarray(g).astype(jnp.bfloat16)
        updates, j_state = tx.update({"w": gb}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        param.grad = torch.tensor(_np(gb)).bfloat16()
        opt.step()
    assert param.dtype == torch.bfloat16 and j_params["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(param), _np(j_params["w"]))
    mu = jax.tree_util.tree_leaves(j_state[0].mu)[0]
    assert str(mu.dtype) == str(opt.state[param]["mu"].dtype).replace("torch.", "")
    np.testing.assert_array_equal(_np(opt.state[param]["mu"]), _np(mu))


# ------------------------------------------------------ serving, checkpoints --


def _served_pair(model, params, jmodel, x, **kw):
    got = CompiledForward(model, torch.from_numpy(x), batch_sizes=(1, 2), device="cpu",
                          **kw)(torch.from_numpy(x))
    want = JCompiledForward(jmodel, params, jnp.asarray(x), batch_sizes=(1, 2),
                            param_dtype=jnp.bfloat16)(jnp.asarray(x))
    return got, want


def test_compiled_forward_bf16_params_on_f32_requests_matches_jax(jax_xla):
    jmodel, params, model = _models()
    x, _ = _pairs(4, 2)
    got, want = _served_pair(model, params, jmodel, x, param_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}  # the caller's copy
    assert _rel_l2(_np(got), _np(want)) <= 1e-5


def test_compiled_forward_of_a_mixed_model_on_bf16_requests_matches_jax(jax_xla):
    """The JAX class compiles ahead of time (no eager run), so the port's
    answer is held to the eager forward of the same bf16 weights to the bit
    and to the JAX class within 2e-2 (XLA's excess precision under jit)."""
    jmodel, params, model = _models(**MIXED)
    x = jnp.asarray(_pairs(4, 2)[0]).astype(jnp.bfloat16)
    compiled = JCompiledForward(jmodel, params, x, batch_sizes=(1, 2),
                                param_dtype=jnp.bfloat16)(x)
    bf16_params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    eager = jmodel.apply({"params": bf16_params}, x)
    xt = torch.from_numpy(_np(x)).bfloat16()
    got = CompiledForward(model, xt, batch_sizes=(1, 2), param_dtype=torch.bfloat16,
                          device="cpu")(xt)
    assert got.dtype == torch.bfloat16 and compiled.dtype == eager.dtype == jnp.bfloat16
    assert _rel_l2(_np(got), _np(eager)) <= EXACT
    assert _rel_l2(_np(got), _np(compiled)) <= 2e-2


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_mixed_run_checkpoint_is_the_jax_file(tmp_path, policy):
    """bf16 spectral weights and the optimizer state of a mixed run, written
    by both packages for the same values: the same bytes, read back by JAX."""
    jmodel, params, model = _models(**MIXED)
    tx = jopt.build_optimizer(_cfg_lr(policy), 2)
    opt_state = tx.init(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params))
    rng = np.random.default_rng(5)
    j_params = _fresh(params)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)).astype(p.dtype), j_params)
        updates, opt_state = tx.update(grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    j_params, opt_state = jax.device_get(j_params), jax.device_get(opt_state)
    model.load_state_dict(convert.convert_flax_params(j_params, model.state_dict(),
                                                      device="cpu"))
    opt = build_optimizer(_cfg_lr(policy), 2).bind(model.named_parameters())
    opt.load_state_dict(fser.to_state_dict(opt_state))
    assert serialization.msgpack_serialize(convert.to_flax_params(model.state_dict())) == \
        fser.to_bytes(j_params)
    assert serialization.msgpack_serialize(opt.state_dict()) == fser.to_bytes(opt_state)

    from neuraloperator_tpu_torch.training import training_state as tts

    # an f32 checkpoint loads into the bf16-weight model rounded, as JAX casts
    # a checkpoint's leaves to the template's dtypes
    f32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), j_params)
    cast = convert.convert_flax_params(f32, model.state_dict(), device="cpu")
    assert cast["fno_blocks.conv_0.w_weight"].dtype == torch.bfloat16
    assert torch.equal(cast["fno_blocks.conv_0.w_weight"],
                       model.state_dict()["fno_blocks.conv_0.w_weight"])

    tts.save_training_state(tmp_path, "model", model.state_dict(), opt.state_dict(), epoch=1)
    back, back_opt, epoch = jts.load_training_state(tmp_path, "model", params, opt_state)
    assert epoch == 1
    assert back["fno_blocks"]["conv_0"]["w_weight"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves((back, back_opt)),
                    jax.tree_util.tree_leaves((j_params, opt_state))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cfg_lr(policy):
    return SimpleNamespace(learning_rate=1e-2, step_size=1, gamma=0.5, weight_decay=1e-4,
                           opt_state=policy)


# ------------------------------------------- precision switches, counters --


@pytest.fixture
def restore_matmul_flags():
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    yield
    flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved
    torch.set_float32_matmul_precision("highest")


def test_dft_matmul_switches_are_scoped(monkeypatch, restore_matmul_flags):
    """``setup(matmul_precision="tensorfloat32")`` turns TF32 on; the DFT
    matmuls of a spectral forward and backward run with TF32 and bf16
    reduced-precision reductions off, and the caller's values are back
    after them."""
    setup(matmul_precision="tensorfloat32")
    flags = torch.backends.cuda.matmul
    flags.allow_bf16_reduced_precision_reduction = True
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append((flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction))
        return matmul(*args, **kwargs)

    monkeypatch.setattr(torch, "matmul", spy)
    for precision in ("full", "mixed"):
        conv = SpectralConv(3, 3, (4, 4), fno_block_precision=precision, device="cpu")
        x = torch.randn(2, 3, 8, 8, requires_grad=True)
        conv(x).float().sum().backward()
    assert len(seen) >= 20 and set(seen) == {(False, False)}
    assert flags.allow_tf32 and flags.allow_bf16_reduced_precision_reduction
    assert torch.get_float32_matmul_precision() == "high"


def test_launch_counts_by_dtype():
    """The per-name counts keep their meaning; counts by dtype add up to them,
    and ``add_launches`` (a CUDA graph's replays) moves both."""
    saved = tsc.launch_counts(by_dtype=True)
    tsc.reset_launch_counts()
    try:
        tsc.add_launches({"mode_contraction": {"bfloat16": 3, "float32": 1},
                          "mode_contraction_dw": {"bfloat16": 2}})
        assert tsc.launch_counts() == {"mode_contraction": 4, "mode_contraction_dx": 0,
                                       "mode_contraction_dw": 2}
        by_dtype = tsc.launch_counts(by_dtype=True)
        assert by_dtype["mode_contraction"] == {"float32": 1, "bfloat16": 3}
        assert by_dtype["mode_contraction_dw"] == {"float32": 0, "bfloat16": 2}
        # a CPU contraction runs the plain version and counts nothing
        x = torch.randn(2, 3, 5).bfloat16()
        tsc.mode_contraction(x, x, torch.randn(3, 4, 5).bfloat16(),
                             torch.randn(3, 4, 5).bfloat16())
        assert tsc.launch_counts(by_dtype=True) == by_dtype
    finally:
        tsc.reset_launch_counts()
        tsc.add_launches(saved)
