"""CODALayer and the port's irfftn of a spectrum that is not Hermitian,
against the JAX package and numpy.

Each flax ``CODALayer`` is initialised, its parameters go through the
port's converter (which checks every name and shape: ``Key``, ``Query``,
``Value``, ``multi_head_proj``, ``mixer``, the norms) into the port's
layer, and both run the same seeded numpy input. Their spectral weights are
the layer's rank-1.0 Tucker factors contracted "factorized": XLA einsums in
JAX, the port's einsum chain (``ops/complex_einsum.py``), no Pallas kernel.
Small widths (6 channels, tokens of 1 or 2, 4x4 modes, 9² grids).

Tolerances, f32: forwards within 1e-5 relative l2; gradients within 1e-4
relative l2 per leaf, against the larger of the leaf's norm and 1% of the
whole gradient's (``tests/test_torch_layer_options.py``);
``irfftn_pocketfft`` in float64 against ``numpy.fft.irfftn`` within 1e-12
relative l2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.layers import coda_layer as jcoda
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.layers import CODALayer
from neuraloperator_tpu_torch.models.codano import irfftn_pocketfft

torch.set_num_threads(1)

MODEL_TOL, GRAD_TOL = 1e-5, 1e-4


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


# ------------------------------------------------------------------ irfftn


@pytest.mark.parametrize("s", [(7,), (8,), (6, 8), (5, 7), (4, 6, 5), (4, 5, 6)])
def test_irfftn_pocketfft_is_numpys_on_a_spectrum_that_is_not_hermitian(s):
    rng = np.random.default_rng(len(s))
    shape = (3, *s[:-1], s[-1] // 2 + 1)
    spec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = np.fft.irfftn(spec, s=s, axes=tuple(range(-len(s), 0)))
    got = irfftn_pocketfft(torch.from_numpy(spec), list(s)).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= 1e-12


# --------------------------------------------------------------- CODALayer


LAYER_CASES = {
    "equivariant_per_channel": dict(per_channel_attention=True),
    "equivariant_two_heads_nonlinear": dict(per_channel_attention=False, token_codimension=2,
                                            n_heads=2, nonlinear_attention=True,
                                            temperature=0.5),
    "non_equivariant_tokens": dict(per_channel_attention=False, token_codimension=2,
                                   permutation_eq=False, codimension_size=6),
    "non_equivariant_per_channel_scaled": dict(per_channel_attention=True,
                                               permutation_eq=False, codimension_size=6,
                                               resolution_scaling_factor=0.5),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_coda_layer(case):
    kwargs = LAYER_CASES[case]
    jm = jcoda.CODALayer(n_modes=(4, 4), **kwargs)
    tm = CODALayer((4, 4), **kwargs, device="cpu")
    x = _rand(1, 2, 6, 9, 9)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    _load(tm, params)
    if kwargs.get("n_heads"):
        assert tm.multi_head_proj is not None
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    assert got.shape == want.shape  # 9 * 0.5 floors to 4, as in JAX
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL
    r = _rand(2, *want.shape)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r)))(
        params)
    (got * torch.from_numpy(r)).sum().backward()
    _check_grads(jgrads, tm)


def test_coda_layer_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="norm"):
        CODALayer((4, 4), norm="batch_norm", device="cpu")
    tm = CODALayer((4, 4), per_channel_attention=False, token_codimension=4, device="cpu")
    with pytest.raises(ValueError, match="tokens"):
        tm(torch.zeros(1, 6, 8, 8))
