"""CODANO in the port against the JAX package.

The flax CODANO is initialised, its parameters go through the port's
converter (which checks every name and shape: ``attention_{i}.Key...``,
``pos_enc_{vid}``, ``cls_token``, ``skip_map_{k}``, ``lifting``,
``projection``) into the port's CODANO, and both run the same seeded numpy
input. Small widths (hidden codimension 4, tokens of 2 channels, 4x4
modes, 2 layers); the full case has every option at once: positional
encodings (through ``_irfft_param``, the port's ``irfftn_pocketfft``), a
CLS token, a static channel, a horizontal skip, per-layer scaling (0.5 then
2) and domain padding.

Tolerances:
- forwards, f32 against f32: within 3e-5 relative l2. Not 1e-5: at these
  widths JAX's f32 forward itself lies 1.4-1.6e-5 from its float64 one
  (its Tucker einsum chains and the chained instance norms round more), so
  the port, 2-3e-6 from its own float64 forward, reads 1.0-1.6e-5 against
  it (CPU probes: JAX f32 against JAX f64 1.6e-5 and 1.4e-5 for the plain
  and full cases at 3 layers; the port's f32 against JAX f64 1.0-1.2e-5 in
  the plain case at 2 layers; the two float64 forwards 0.6-1.5e-6 apart,
  from the f32 interpolation and DFT constants both packages build);
- H1 gradients, f32 against f32: within 1e-4 relative l2 per leaf, against
  the larger of the leaf's norm and 1% of the whole gradient's
  (``tests/test_torch_layer_options.py``);
- ``per_channel_attention=True`` (no recorded configuration uses it), f32
  against JAX's forward with x64 on: within 5e-5 relative l2. At the
  first seed the model is ill-conditioned: a 1e-7 relative perturbation
  of its float64 weights moves its float64 output by 9.9e-6, so the
  f32-rounded DFT and interpolation constants both packages keep put the
  port's own float64 forward 3.5e-5 from JAX's. CPU probes over seeds
  0-3 at 16² and 12²: the port's f32 forward 5.6e-7 to 3.7e-5 from JAX's
  x64 one, JAX's f32 forward 4.0e-7 to 5.8e-6 from it;
- ``extend_variable_ids``: the known variables' outputs equal to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.losses import H1Loss as JH1Loss
from neuraloperator_tpu.models import codano as jcodano
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.models import CODANO, extend_variable_ids, get_model

torch.set_num_threads(1)

FORWARD_TOL, GRAD_TOL = 3e-5, 1e-4
PER_CHANNEL_X64_TOL = 5e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_grads(jgrads, port_module):
    jgrads = convert.flatten_flax(jgrads)
    tgrads = {n: p.grad for n, p in port_module.named_parameters()}
    assert set(tgrads) == set(jgrads)
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jgrads.values()))
    for name, ref in jgrads.items():
        ref = np.asarray(ref, np.float64)
        err = np.linalg.norm(tgrads[name].double().numpy() - ref)
        assert err / max(np.linalg.norm(ref), 1e-2 * total) <= GRAD_TOL, name


def _load(port_module, params):
    port_module.load_state_dict(
        convert.convert_flax_params(params, port_module.state_dict(), device="cpu"))
    return port_module


# ------------------------------------------------------------------- CODANO


def _codano_kwargs(**extra):
    kwargs = dict(n_modes=((4, 4),) * 2, n_layers=2, hidden_variable_codimension=4,
                  lifting_channels=8, projection_channels=8, attention_token_dim=2,
                  per_channel_attention=False, domain_padding=None)
    kwargs.update(extra)
    return kwargs


FULL = dict(use_positional_encoding=True, positional_encoding_dim=2,
            positional_encoding_modes=(6, 6), variable_ids=("a", "b"), static_channel_dim=1,
            horizontal_skips_map={1: 0}, per_layer_scaling_factors=((0.5, 0.5), (2, 2)),
            enable_cls_token=True, domain_padding=0.25)


def _codano_pair(**extra):
    jm = jcodano.CODANO(**_codano_kwargs(**extra))
    tm = CODANO(**_codano_kwargs(**extra), device="cpu")
    return jm, tm


def _codano_inputs(res, extra, seed=0):
    x = _rand(seed, 2, 2, res, res)
    call = {}
    if extra.get("static_channel_dim"):
        call["static_channel"] = _rand(seed + 1, 2, extra["static_channel_dim"], res, res)
    ids = ["b", "a"] if extra.get("use_positional_encoding") else None
    return x, call, ids


@pytest.mark.parametrize("res", [16, 12])
@pytest.mark.parametrize("case", ["plain", "pe_cls_static_skips_scaling_padding"])
def test_codano_forward(case, res):
    extra = FULL if case != "plain" else {}
    jm, tm = _codano_pair(**extra)
    x, call, ids = _codano_inputs(res, extra)
    jcall = {k: jnp.asarray(v) for k, v in call.items()}
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), input_variable_ids=ids,
                     **jcall)["params"]
    _load(tm, params)
    want = np.asarray(jax.jit(lambda p, x, c: jm.apply({"params": p}, x, input_variable_ids=ids,
                                                       **c))(params, jnp.asarray(x), jcall))
    got = tm(torch.from_numpy(x), input_variable_ids=ids,
             **{k: torch.from_numpy(v) for k, v in call.items()}).detach().numpy()
    assert got.shape == want.shape == (2, 2, res, res)
    assert _rel_l2(got, want) <= FORWARD_TOL


@pytest.mark.parametrize("res", [16, 12])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codano_per_channel_attention_against_jax_float64(seed, res):
    """Tokens of one channel each, keys and queries at half the resolution;
    the reference is JAX's forward of the same weights with x64 on."""
    jm, tm = _codano_pair(per_channel_attention=True)
    x, _, _ = _codano_inputs(res, {}, seed=seed)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    _load(tm, params)
    with jax.enable_x64(True):
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                          params)
        want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
            params64, jnp.asarray(x, jnp.float64)))
    assert want.dtype == np.float64
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2, res, res)
    assert _rel_l2(got, want) <= PER_CHANNEL_X64_TOL


def test_codano_h1_gradients():
    """Every option at once, on a unit-spaced grid
    (``tests/test_torch_layer_options.py``)."""
    jm, tm = _codano_pair(**FULL)
    x, call, ids = _codano_inputs(16, FULL, seed=3)
    y = 1.0 + _rand(5, 2, 2, 16, 16)
    jcall = {k: jnp.asarray(v) for k, v in call.items()}
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), input_variable_ids=ids,
                     **jcall)["params"]
    _load(tm, params)
    jloss, tloss = JH1Loss(d=2, measure=[16.0, 16.0]), H1Loss(d=2, measure=[16.0, 16.0])
    jgrads = jax.jit(jax.grad(lambda p: jloss(jm.apply({"params": p}, jnp.asarray(x),
                                                       input_variable_ids=ids, **jcall),
                                              jnp.asarray(y))))(params)
    tloss(tm(torch.from_numpy(x), input_variable_ids=ids,
             **{k: torch.from_numpy(v) for k, v in call.items()}),
          torch.from_numpy(y)).backward()
    _check_grads(jgrads, tm)


def test_extend_variable_ids_keeps_the_known_variables_to_the_bit():
    kwargs = _codano_kwargs(use_positional_encoding=True, positional_encoding_dim=2,
                            variable_ids=("a", "b"), enable_cls_token=True)
    model = CODANO(**kwargs, device="cpu", generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    before = {k: v.clone() for k, v in state.items()}
    new_model, new_state = extend_variable_ids(model, state, ["c", "a", "c", "d"],
                                               torch.Generator().manual_seed(1))
    assert new_model.variable_ids == ("a", "b", "c", "d")
    assert model.variable_ids == ("a", "b")
    assert set(new_state) == set(state) | {"pos_enc_c", "pos_enc_d"}
    assert all(new_state[k] is v for k, v in state.items())  # every leaf reused
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
    x = torch.from_numpy(_rand(7, 2, 2, 12, 12))
    with torch.no_grad():
        want = model(x, input_variable_ids=["b", "a"])
        got = new_model(x, input_variable_ids=["b", "a"])
        assert torch.equal(got, want)
        assert new_model(torch.cat([x, x[:, :1]], dim=1),
                         input_variable_ids=["d", "a", "c"]).shape == (2, 3, 12, 12)
    with pytest.raises(ValueError, match="positional"):
        extend_variable_ids(CODANO(**_codano_kwargs(), device="cpu"), state, ["c"])


def test_codano_is_registered_and_checks_its_inputs():
    model = get_model({"model_arch": "CODANO", **_codano_kwargs(static_channel_dim=1)},
                      device="cpu")
    assert isinstance(model, CODANO)
    with pytest.raises(ValueError, match="static_channel"):
        model(torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="variable_ids"):
        CODANO(**_codano_kwargs(use_positional_encoding=True), device="cpu")
