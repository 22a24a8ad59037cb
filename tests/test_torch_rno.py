"""RNO, RNOBlock and RNOCell in the port against the JAX package.

The flax modules are initialised, their parameters go through the port's
converter (which checks every name and shape: ``input_gate_{0,1,2}``,
``hidden_gate_{0,1,2}``, ``bias_{0,1,2}`` under ``cell``, ``bias_h`` on
each ``rno_block_{i}``, ``lifting``, ``projection``) into the port's
modules, and both run the same seeded numpy input, the JAX side reaching
the Pallas contraction in interpret mode, as the JAX package's own tests
run it. Small widths (hidden 8, 8 modes in 1-D, 4x4 in 2-D, 3 frames).

Tolerances, f32: forwards and rollouts within 1e-5 relative l2 (a CPU
probe of these cases read at most 1.0e-6); gradients of the relative L2
loss within 1e-4 relative l2 per leaf, against the larger of the leaf's
norm and 1% of the whole gradient's (``tests/test_torch_layer_options.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuraloperator_tpu.layers import rno_block as jblock
from neuraloperator_tpu.losses import LpLoss as JLpLoss
from neuraloperator_tpu.models import rno as jrno
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.layers.rno_block import RNOBlock, RNOCell
from neuraloperator_tpu_torch.losses import LpLoss
from neuraloperator_tpu_torch.models import RNO, available_models, get_model

torch.set_num_threads(1)

MODEL_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port(cls, params, **kwargs):
    module = cls(**kwargs, device="cpu")
    module.load_state_dict(convert.convert_flax_params(params, module.state_dict(),
                                                       device="cpu"))
    return module


def _check_grads(jgrads, module):
    jgrads = convert.flatten_flax(jgrads)
    # a parameter outside the loss (bias_h under a given state) has no
    # gradient in torch and a zero one in JAX
    tgrads = {n: torch.zeros_like(p) if p.grad is None else p.grad
              for n, p in module.named_parameters()}
    assert set(tgrads) == set(jgrads)
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jgrads.values()))
    for name, ref in jgrads.items():
        ref = np.asarray(ref, np.float64)
        err = np.linalg.norm(tgrads[name].double().numpy() - ref)
        assert err / max(np.linalg.norm(ref), 1e-2 * total) <= GRAD_TOL, name


CELL_CASES = {
    "1d": (dict(n_modes=(8,)), (2, 8, 16), (2, 8, 16)),
    "2d": (dict(n_modes=(4, 4)), (2, 8, 12, 12), (2, 8, 12, 12)),
    "1d_scaled_input": (dict(n_modes=(4,), resolution_scaling_factor=0.5), (2, 8, 16),
                        (2, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_rno_cell_forward_and_gradients(jax_pallas, case):
    kwargs, x_shape, h_shape = CELL_CASES[case]
    jm = jblock.RNOCell(hidden_channels=8, **kwargs)
    x, h = _rand(0, *x_shape), _rand(1, *h_shape)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(h))["params"]
    assert {"bias_0", "bias_1", "bias_2", "input_gate_0", "hidden_gate_2"} <= set(params)
    tm = _port(RNOCell, params, hidden_channels=8, **kwargs)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(h)))
    got = tm(torch.from_numpy(x), torch.from_numpy(h))
    assert tuple(got.shape) == want.shape == h_shape
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL
    y = _rand(2, *h_shape)
    d = len(kwargs["n_modes"])
    jgrads = jax.jit(jax.grad(lambda p: JLpLoss(d=d)(
        jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(h)), jnp.asarray(y))))(params)
    LpLoss(d=d)(got, torch.from_numpy(y)).backward()
    _check_grads(jgrads, tm)


BLOCK_CASES = {
    "last_state": (dict(n_modes=(8,)), (2, 3, 8, 16), None),
    "sequences": (dict(n_modes=(8,), return_sequences=True), (2, 3, 8, 16), None),
    "given_state": (dict(n_modes=(8,)), (2, 3, 8, 16), (2, 8, 16)),
    "scaled_sequences": (dict(n_modes=(4,), return_sequences=True,
                              resolution_scaling_factor=0.5), (2, 3, 8, 16), None),
    "2d": (dict(n_modes=(4, 4)), (2, 2, 8, 12, 12), None),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_rno_block_forward_and_gradients(jax_pallas, case):
    kwargs, x_shape, h_shape = BLOCK_CASES[case]
    jm = jblock.RNOBlock(hidden_channels=8, **kwargs)
    x = _rand(3, *x_shape)
    h = None if h_shape is None else _rand(4, *h_shape)
    jh = None if h is None else jnp.asarray(h)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jh)["params"]
    assert set(params) == {"bias_h", "cell"}
    tm = _port(RNOBlock, params, hidden_channels=8, **kwargs)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jh))
    got = tm(torch.from_numpy(x), None if h is None else torch.from_numpy(h))
    assert tuple(got.shape) == want.shape
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL
    y = _rand(5, *want.shape)
    d = len(kwargs["n_modes"])
    jgrads = jax.jit(jax.grad(lambda p: JLpLoss(d=d)(
        jm.apply({"params": p}, jnp.asarray(x), jh), jnp.asarray(y))))(params)
    LpLoss(d=d)(got, torch.from_numpy(y)).backward()
    _check_grads(jgrads, tm)


def _rno_kwargs(**extra):
    kwargs = dict(n_modes=(8,), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)
    kwargs.update(extra)
    return kwargs


MODEL_CASES = {
    "1d": (_rno_kwargs(), (2, 3, 1, 16)),
    "2d": (_rno_kwargs(n_modes=(4, 4)), (2, 3, 1, 12, 12)),
    "no_skip_three_layers": (_rno_kwargs(rno_skip=False, n_layers=3), (2, 3, 1, 16)),
    "domain_padding": (_rno_kwargs(domain_padding=0.25), (2, 3, 1, 16)),
    "two_channels_no_embedding": (_rno_kwargs(in_channels=2, out_channels=2,
                                              positional_embedding=None), (2, 3, 2, 16)),
}


def _rno_pair(case, seed=0):
    kwargs, shape = MODEL_CASES[case]
    jm = jrno.RNO(**kwargs)
    x = _rand(seed + 10, *shape)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return jm, params, _port(RNO, params, **kwargs), x


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_rno_forward_and_gradients(jax_pallas, case):
    jm, params, tm, x = _rno_pair(case)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL
    y = _rand(20, *want.shape)
    d = len(MODEL_CASES[case][0]["n_modes"])
    jgrads = jax.jit(jax.grad(lambda p: JLpLoss(d=d)(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))))(params)
    LpLoss(d=d)(got, torch.from_numpy(y)).backward()
    _check_grads(jgrads, tm)


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_rno_hidden_states_in_and_out(jax_pallas, case):
    jm, params, tm, x = _rno_pair(case, seed=1)
    states = [_rand(30 + i, *((2, 8) + x.shape[3:])) for i in range(2)]
    want, want_states = jax.jit(lambda p, a, s: jm.apply(
        {"params": p}, a, init_hidden_states=s, return_hidden_states=True))(
        params, jnp.asarray(x), [jnp.asarray(s) for s in states])
    got, got_states = tm(torch.from_numpy(x), init_hidden_states=[torch.from_numpy(s)
                                                                   for s in states],
                         return_hidden_states=True)
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL
    assert len(got_states) == len(want_states) == 2
    for g, w in zip(got_states, want_states):
        assert tuple(g.shape) == w.shape
        assert _rel_l2(g.detach().numpy(), w) <= MODEL_TOL


@pytest.mark.parametrize("case", ["1d", "2d", "no_skip_three_layers"])
def test_rno_predict_rollout(jax_pallas, case):
    jm, params, tm, x = _rno_pair(case, seed=2)
    x = x[:, -1:]
    want = np.asarray(jm.predict({"params": params}, jnp.asarray(x), 4))
    with torch.no_grad():
        got = tm.predict(torch.from_numpy(x), 4).numpy()
    assert got.shape == want.shape == (2, 4) + x.shape[2:]
    assert _rel_l2(got, want) <= MODEL_TOL


def test_rno_predict_with_a_grid_function(jax_pallas):
    kwargs = _rno_kwargs(in_channels=2, out_channels=1)
    jm = jrno.RNO(**kwargs)
    x = _rand(40, 2, 1, 2, 16)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tm = _port(RNO, params, **kwargs)
    grid = np.linspace(0, 1, 16, dtype=np.float32)

    def grid_channel(shape, lib):
        return lib.broadcast_to(lib.asarray(grid), shape)

    want = np.asarray(jm.predict({"params": params}, jnp.asarray(x), 3,
                                 grid_function=lambda s: grid_channel(s, jnp)))
    with torch.no_grad():
        got = tm.predict(torch.from_numpy(x), 3, grid_function=lambda s: torch.from_numpy(
            grid).expand(s)).numpy()
    assert _rel_l2(got, want) <= MODEL_TOL


def test_rno_converter_covers_the_tree_both_ways():
    for case in ("1d", "2d", "no_skip_three_layers"):
        kwargs, shape = MODEL_CASES[case]
        shapes = jax.eval_shape(lambda: jrno.RNO(**kwargs).init(
            jax.random.PRNGKey(0), jnp.zeros(shape)))["params"]
        port = RNO(**kwargs, device="meta")
        convert.check_flax_params(shapes, port.state_dict())
        names = {n for n, _ in port.named_parameters()}
        n_layers = kwargs["n_layers"]
        assert {f"rno_block_{n_layers - 1}.bias_h", "rno_block_0.cell.bias_0",
                "rno_block_0.cell.input_gate_2.conv_0.w_weight",
                "rno_block_1.cell.hidden_gate_1.channel_mlp_0.w1"} <= names
        gates = {n.split(".")[2] for n in names if n.startswith("rno_block_0.cell.")}
        assert gates == {f"{kind}_gate_{i}" for kind in ("input", "hidden") for i in range(3)} | {
            f"bias_{i}" for i in range(3)}
    tm = RNO(**_rno_kwargs(), device="cpu", generator=torch.Generator().manual_seed(0))
    tree = convert.to_flax_params(tm.state_dict())
    back = convert.convert_flax_params(tree, tm.state_dict(), device="cpu")
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


def test_rno_scalar_biases_are_unit_normal():
    """bias_{0,1,2} and bias_h: flax ``normal(1.0)``, scalars."""
    draws = []
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        block = RNOBlock(n_modes=(2,), hidden_channels=2, device="cpu", generator=gen)
        draws += [float(block.bias_h)] + [float(getattr(block.cell, f"bias_{i}"))
                                          for i in range(3)]
        assert block.bias_h.shape == () and block.cell.bias_0.shape == ()
    draws = np.asarray(draws)
    # 160 draws of N(0, 1): the mean within 4 standard errors, the std within 20%
    assert abs(draws.mean()) <= 4 / np.sqrt(len(draws))
    assert 0.8 <= draws.std() <= 1.2
    # the same weights from the same seed, on any device
    a = RNO(**_rno_kwargs(), device="cpu", generator=torch.Generator().manual_seed(5))
    b = RNO(**_rno_kwargs(), device="cpu", generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())


def test_rno_refuses_what_jax_refuses():
    jm = jrno.RNO(**_rno_kwargs())
    tm = RNO(**_rno_kwargs(), device="cpu")
    for shape in ((2, 1, 16), (2, 3, 2, 16)):
        with pytest.raises(ValueError) as jerr:
            jm.init(jax.random.PRNGKey(0), jnp.zeros(shape))
        with pytest.raises(ValueError) as terr:
            tm(torch.zeros(shape))
        assert str(terr.value).split(",")[0] == str(jerr.value).split(",")[0]


def test_rno_returning_sequences_fails_at_the_projection_as_in_jax():
    """With ``return_sequences`` the last layer hands the projection a
    (b, t, c, x) sequence, which neither package's channel MLP takes."""
    kwargs = _rno_kwargs(n_layers=1, return_sequences=True)
    x = np.zeros((2, 3, 1, 16), np.float32)
    with pytest.raises(ValueError):
        jrno.RNO(**kwargs).init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(RuntimeError):
        RNO(**kwargs, device="cpu")(torch.from_numpy(x))


def test_rno_is_registered():
    assert "rno" in available_models()
    model = get_model({"model_arch": "RNO", "n_modes": [8], "in_channels": 1,
                       "out_channels": 1, "hidden_channels": 8, "n_layers": 2},
                      device="cpu")
    assert isinstance(model, RNO) and model.n_layers == 2
