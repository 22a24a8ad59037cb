"""UNO in the port against the JAX package.

The flax UNO is initialised, its parameters go through the port's converter
(which checks every name and shape: ``block_{i}``, ``horizontal_skip_{i}``,
``lifting``, ``projection``) into the port's UNO, and both run the same
seeded numpy input, the JAX side reaching the Pallas contraction in
interpret mode, as the JAX package's own tests run it. Small widths (hidden
8, blocks of 4 to 8 channels, 4x4 modes), five blocks as in the recorded
configuration (``scripts/train_family_quality.py``): channels change at
each skip (block 3 takes 8 + 8 channels in, block 4 takes 8 + 4), grids
halve and double, and a 32² input goes through the same weights.

Tolerances, f32: forwards within 1e-5 relative l2; H1 gradients within
1e-4 relative l2 per leaf, against the larger of the leaf's norm and 1% of
the whole gradient's (``tests/test_torch_layer_options.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuraloperator_tpu.losses import H1Loss as JH1Loss
from neuraloperator_tpu.models import uno as juno
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.models import UNO, get_model

torch.set_num_threads(1)

MODEL_TOL, GRAD_TOL = 1e-5, 1e-4
RECORDED_SCALINGS = ((1, 1), (0.5, 0.5), (1, 1), (2, 2), (1, 1))


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


def _kwargs(**extra):
    kwargs = dict(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=16,
                  projection_channels=16, n_layers=5, uno_out_channels=(4, 8, 8, 8, 4),
                  uno_n_modes=((4, 4),) * 5, uno_scalings=RECORDED_SCALINGS,
                  channel_mlp_skip="linear")
    kwargs.update(extra)
    return kwargs


def _pair(seed=0, **extra):
    jm = juno.UNO(**_kwargs(**extra))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, 16, 16)))["params"]
    tm = UNO(**_kwargs(**extra), device="cpu")
    tm.load_state_dict(convert.convert_flax_params(params, tm.state_dict(), device="cpu"))
    return jm, params, tm


CASES = {
    "recorded_default_skips": {},
    "custom_skips": dict(horizontal_skips_map={4: 0, 2: 1}),
    "domain_padding": dict(domain_padding=0.25),
    "scaled_end_to_end_soft_gating_norm": dict(
        uno_scalings=((1, 1), (0.75, 0.75), (1, 1), (2, 2), (1, 1)),
        horizontal_skip="soft-gating", norm="instance_norm"),
    "no_embedding_three_blocks": dict(positional_embedding=None, n_layers=3,
                                      uno_out_channels=(4, 8, 4), uno_n_modes=((4, 4),) * 3,
                                      uno_scalings=(1, 0.5, 2)),
}


@pytest.mark.parametrize("res", [16, 32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_uno_forward(jax_pallas, case, res):
    jm, params, tm = _pair(**CASES[case])
    x = _rand(res, 2, 1, res, res)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= MODEL_TOL


@pytest.mark.parametrize("case", ["recorded_default_skips", "custom_skips", "domain_padding"])
def test_uno_h1_gradients(jax_pallas, case):
    """On a unit-spaced grid (``tests/test_torch_layer_options.py``)."""
    jm, params, tm = _pair(**CASES[case])
    x, y = _rand(1, 2, 1, 16, 16), 1.0 + _rand(2, 2, 1, 16, 16)
    jloss, tloss = JH1Loss(d=2, measure=[16.0, 16.0]), H1Loss(d=2, measure=[16.0, 16.0])
    jgrads = convert.flatten_flax(jax.jit(jax.grad(
        lambda p: jloss(jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))))(params))
    tloss(tm(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(tgrads) == set(jgrads)
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jgrads.values()))
    for name, ref in jgrads.items():
        ref = np.asarray(ref, np.float64)
        err = np.linalg.norm(tgrads[name].double().numpy() - ref)
        assert err / max(np.linalg.norm(ref), 1e-2 * total) <= GRAD_TOL, name


def test_uno_layout_and_skip_widths():
    tm = UNO(**_kwargs(), device="meta")
    assert tm.skips_map == {4: 0, 3: 1}
    names = {n.split(".")[0] for n, _ in tm.named_parameters()}
    assert names == {"lifting", "projection", *(f"block_{i}" for i in range(5)),
                     "horizontal_skip_0", "horizontal_skip_1"}
    # the skips widen the blocks they enter: 8 + 8 into block 3, 8 + 4 into block 4
    assert tuple(tm.block_3.conv_0.w_weight.shape[1:3]) == (16, 8)
    assert tuple(tm.block_4.conv_0.w_weight.shape[1:3]) == (12, 4)
    assert tm.end_to_end_scaling == [1.0, 1.0]


def test_uno_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="one entry per layer"):
        UNO(**_kwargs(n_layers=4), device="cpu")
    with pytest.raises(ValueError, match="positional_embedding"):
        UNO(**_kwargs(positional_embedding="sine"), device="cpu")


def test_uno_is_registered():
    model = get_model({"model_arch": "UNO", **_kwargs()}, device="cpu")
    assert isinstance(model, UNO)
    assert model._init_kwargs["uno_scalings"] == RECORDED_SCALINGS
