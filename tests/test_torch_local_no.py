"""LocalNO's layers and model in the port against the JAX package.

Each flax module is initialised, its parameters go through the port's
converter into the port module (``convert.convert_flax_params``, which also
checks every name and shape), and both run the same seeded numpy input.
The whole-model and block tests force the JAX contraction backend to the
Pallas kernel in interpret mode, as the JAX package's own tests run it.

Tolerances, f32 throughout:
- the numpy filter basis and filter matrices: equal to the bit (copied);
- forwards of convolutions, blocks and whole models, and the input's
  gradient: relative l2 <= 1e-5 (elementwise bounds do not suit the
  finite-difference convolution, a difference of two convolutions whose
  near-zero entries keep the larger terms' rounding);
- gradients: relative l2 <= 1e-4 per leaf (the card-against-CPU bound of a
  step), against the larger of the leaf's norm and 1% of the whole
  gradient's, as ``tests/test_torch_layer_options.py`` holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuraloperator_tpu.layers import differential_conv as jdiff
from neuraloperator_tpu.layers import discrete_continuous_convolution as jdisco
from neuraloperator_tpu.layers import local_no_block as jblk
from neuraloperator_tpu.losses import H1Loss as JH1Loss
from neuraloperator_tpu.models import local_no as jlocal
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.layers import differential_conv as tdiff
from neuraloperator_tpu_torch.layers import discrete_continuous_convolution as tdisco
from neuraloperator_tpu_torch.layers.local_no_block import LocalNOBlocks, disco_kernel_size
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.models import LocalNO, get_model

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


def _init(module, *args, seed=0):
    return module.init(jax.random.PRNGKey(seed), *args)["params"]


def _load(port_module, params):
    port_module.load_state_dict(
        convert.convert_flax_params(params, port_module.state_dict(), device="cpu"))
    return port_module


def _check_grads(jgrads, port_module):
    jgrads = convert.flatten_flax(jgrads)
    tgrads = {n: p.grad for n, p in port_module.named_parameters()}
    assert set(tgrads) == set(jgrads)
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jgrads.values()))
    for name, ref in jgrads.items():
        ref = np.asarray(ref, np.float64)
        got = tgrads[name].detach().double().numpy()
        assert np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-2 * total) <= GRAD_TOL, \
            name


def _weighted_sum_grads(jmodule, params, port_module, inputs, call=(), seed=9):
    """Gradients of sum(out * r) for a seeded r, parameters and the first input."""
    jout = jmodule.apply({"params": params}, *[jnp.asarray(a) for a in inputs], *call)
    r = _rand(seed, *jout.shape)

    def loss(p, x):
        return jnp.sum(jmodule.apply({"params": p}, x, *[jnp.asarray(a) for a in inputs[1:]],
                                     *call) * r)

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(inputs[0]))
    x = torch.from_numpy(inputs[0]).requires_grad_(True)
    tout = port_module(x, *[torch.from_numpy(a) for a in inputs[1:]], *call)
    (tout * torch.from_numpy(r)).sum().backward()
    assert tout.shape == jout.shape
    assert _rel_l2(tout.detach().numpy(), jout) <= MODEL_TOL
    _check_grads(jgp, port_module)
    assert _rel_l2(x.grad.numpy(), jgx) <= MODEL_TOL


# ----------------------------------------------------- finite-difference conv


@pytest.mark.parametrize("n_dim", [1, 2, 3])
@pytest.mark.parametrize("padding", ["periodic", "replicate", "reflect", "zeros"])
@pytest.mark.parametrize("mix_derivatives", [True, False])
def test_finite_difference_convolution(n_dim, padding, mix_derivatives):
    c_in, c_out = 3, 6
    groups = 1 if mix_derivatives else c_in
    size = (9, 7, 6)[:n_dim]
    jm = jdiff.FiniteDifferenceConvolution(c_in, c_out, n_dim, kernel_size=3, groups=groups,
                                           padding=padding)
    x = _rand(n_dim, 2, c_in, *size)
    params = _init(jm, jnp.asarray(x), 0.25)
    tm = _load(tdiff.FiniteDifferenceConvolution(c_in, c_out, n_dim, kernel_size=3,
                                                 groups=groups, padding=padding, device="cpu"),
               params)
    assert tuple(tm.kernel.shape) == (c_out, c_in // groups) + (3,) * n_dim
    _weighted_sum_grads(jm, params, tm, [x], call=(0.25,))


def test_finite_difference_convolution_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="odd"):
        tdiff.FiniteDifferenceConvolution(2, 2, 2, kernel_size=4, device="cpu")
    tm = tdiff.FiniteDifferenceConvolution(2, 2, 2, padding="mirror", device="cpu")
    jm = jdiff.FiniteDifferenceConvolution(2, 2, 2, padding="mirror")
    with pytest.raises(NotImplementedError, match="mirror"):
        tm(torch.zeros(1, 2, 4, 4), 1.0)
    with pytest.raises(NotImplementedError, match="mirror"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 4)), 1.0)


def test_finite_difference_init_follows_the_jax_distribution():
    """flax ``lecun_normal`` reads fan_in from axis -2 of (out, in, k, k):
    the port draws at the same scale from its own generator."""
    tm = tdiff.FiniteDifferenceConvolution(16, 32, 2, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    jm = jdiff.FiniteDifferenceConvolution(16, 32, 2)
    jk = np.asarray(_init(jm, jnp.zeros((1, 16, 5, 5)), 1.0)["kernel"])
    np.testing.assert_allclose(tm.kernel.detach().std().item(), jk.std(), rtol=0.05)


# ------------------------------------------------------------------- DISCO


@pytest.mark.parametrize("kernel_shape,kernel_size,basis_type", [
    ((2, 4), 3, "piecewise_linear"), ((3, 4), 5, "piecewise_linear"),
    ((3,), 5, "piecewise_linear"), ((1,), 3, "piecewise_linear"),
    ((2, 3), 5, "morlet"), ((3,), 5, "morlet"), ((3,), 7, "zernike"),
])
def test_filter_basis_is_equal_to_the_bit(kernel_shape, kernel_size, basis_type):
    got = tdisco.equidistant_filter_basis(kernel_shape, kernel_size, basis_type)
    want = jdisco.equidistant_filter_basis(kernel_shape, kernel_size, basis_type)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] == tdisco.num_basis_functions(kernel_shape, basis_type) == \
        jdisco.num_basis_functions(kernel_shape, basis_type)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("basis_type", ["piecewise_linear", "morlet", "zernike"])
@pytest.mark.parametrize("periodic,transpose", [(False, False), (True, False), (False, True)])
def test_filter_matrix_is_equal_to_the_bit(basis_type, periodic, transpose):
    rng = np.random.default_rng(3)
    pts_in, pts_out = rng.uniform(size=(40, 2)), rng.uniform(size=(25, 2))
    kernel_shape = (3,) if basis_type == "zernike" else (2, 3)
    kwargs = dict(kernel_shape=kernel_shape, radius_cutoff=0.3, basis_type=basis_type,
                  periodic=periodic, transpose=transpose)
    np.testing.assert_array_equal(tdisco.precompute_filter_matrix(pts_in, pts_out, **kwargs),
                                  jdisco.precompute_filter_matrix(pts_in, pts_out, **kwargs))


@pytest.mark.parametrize("groups,use_bias,padding_mode",
                         [(1, True, "periodic"), (2, True, "zeros"), (1, False, "zeros"),
                          (3, False, "periodic")])
def test_equidistant_disco_conv(groups, use_bias, padding_mode):
    c_in, c_out = 6, 12
    kw = dict(kernel_shape=(2, 4), kernel_size=3, groups=groups, use_bias=use_bias,
              padding_mode=padding_mode)
    jm = jdisco.EquidistantDiscreteContinuousConv2d(c_in, c_out, **kw)
    x = _rand(groups, 2, c_in, 10, 8)
    params = _init(jm, jnp.asarray(x))
    if use_bias:  # off zero, so the bias reaches the output
        params = {**params, "bias": jnp.asarray(_rand(5, c_out))}
    tm = _load(tdisco.EquidistantDiscreteContinuousConv2d(c_in, c_out, **kw, device="cpu"),
               params)
    assert sorted(dict(tm.named_parameters())) == sorted(params)
    _weighted_sum_grads(jm, params, tm, [x])


@pytest.mark.parametrize("kernel_size,stride", [(3, 2), (5, 2), (3, 3)])
def test_equidistant_disco_conv_transpose(kernel_size, stride):
    kw = dict(kernel_shape=(2, 4), kernel_size=kernel_size, stride=stride)
    jm = jdisco.EquidistantDiscreteContinuousConvTranspose2d(4, 3, **kw)
    x = _rand(kernel_size, 2, 4, 5, 6)
    params = {**_init(jm, jnp.asarray(x)), "bias": jnp.asarray(_rand(4, 3))}
    tm = _load(tdisco.EquidistantDiscreteContinuousConvTranspose2d(4, 3, **kw, device="cpu"),
               params)
    assert tuple(tm(torch.from_numpy(x)).shape) == (2, 3, 5 * stride, 6 * stride)
    _weighted_sum_grads(jm, params, tm, [x])


@pytest.mark.parametrize("cls", ["DiscreteContinuousConv2d", "DiscreteContinuousConvTranspose2d"])
@pytest.mark.parametrize("groups", [1, 2])
def test_disco_conv_between_point_sets(cls, groups):
    rng = np.random.default_rng(4)
    pts_in, pts_out = rng.uniform(size=(30, 2)), rng.uniform(size=(20, 2))
    psi = jdisco.precompute_filter_matrix(pts_in, pts_out, (2, 3), 0.4,
                                          transpose=cls.endswith("Transpose2d"))
    jm = getattr(jdisco, cls)(4, 6, kernel_shape=(2, 3), groups=groups)
    x = _rand(groups, 2, 4, 30)
    params = {**_init(jm, jnp.asarray(x), jnp.asarray(psi)), "bias": jnp.asarray(_rand(6, 6))}
    tm = _load(getattr(tdisco, cls)(4, 6, kernel_shape=(2, 3), groups=groups, device="cpu"),
               params)
    _weighted_sum_grads(jm, params, tm, [x, psi])


# ------------------------------------------------------------- LocalNOBlocks


def test_disco_kernel_size_follows_the_default_in_shape():
    assert disco_kernel_size(None, (16, 16)) == 3
    assert disco_kernel_size(None, (64, 32)) == 3
    assert disco_kernel_size(0.25, (16, 16)) == 5
    assert disco_kernel_size(0.1, (16, 16)) == 3  # round(0.8) = 1, and at least 1


BLOCK_CASES = {
    "mixed_flags_group_norm": dict(n_layers=3, diff_layers=(True, False, True),
                                   disco_layers=(False, True, True), norm="group_norm",
                                   norm_groups=2),
    "instance_norm_no_mixing_zeros": dict(n_layers=2, norm="instance_norm",
                                          mix_derivatives=False, conv_padding_mode="zeros",
                                          disco_groups=2, disco_bias=False),
    "no_mlp_tanh_scaled": dict(n_layers=2, use_channel_mlp=False, stabilizer="tanh",
                               diff_layers=(False, True), resolution_scaling_factor=[1, 0.5],
                               local_no_skip="soft-gating"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_local_no_blocks(jax_pallas, case):
    kwargs = BLOCK_CASES[case]
    width, n_modes = 8, (6, 6)
    jm = jblk.LocalNOBlocks(in_channels=width, out_channels=width, n_modes=n_modes,
                            default_in_shape=(12, 12), **kwargs)
    tm = LocalNOBlocks(width, width, n_modes, (12, 12), **kwargs, device="cpu")
    x = _rand(1, 2, width, 12, 12)

    def run(module, x):
        for i in range(kwargs["n_layers"]):
            x = module(x, i)
        return x

    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), method=run)["params"]
    _load(tm, params)
    want = jm.apply({"params": params}, jnp.asarray(x), method=run)
    got = run(tm, torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL


def test_local_no_blocks_refuse_what_jax_refuses():
    with pytest.raises(NotImplementedError, match="DISCO"):
        LocalNOBlocks(4, 4, (4,), (8,), device="cpu")
    with pytest.raises(ValueError, match="norm"):
        LocalNOBlocks(4, 4, (4, 4), (8, 8), norm="batch_norm", device="cpu")


# ------------------------------------------------------------------- LocalNO


def _local_no_kwargs(**extra):
    return dict(n_modes=(8, 8), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2,
                default_in_shape=(16, 16), **extra)


@pytest.mark.parametrize("res", [16, 32])
def test_local_no_forward_and_h1_gradients(jax_pallas, res):
    """Trained at 16² (the stencils' and derivatives' scale), evaluated at
    16² and 32²; the H1 loss on a unit-spaced grid (see
    ``tests/test_torch_layer_options.py``)."""
    jm = jlocal.LocalNO(**_local_no_kwargs())
    x = _rand(res, 2, 1, res, res)
    y = 1.0 + _rand(res + 1, 2, 1, res, res)
    params = _init(jm, jnp.asarray(x))
    tm = _load(LocalNO(**_local_no_kwargs(), device="cpu"), params)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert _rel_l2(got.detach().numpy(), want) <= MODEL_TOL
    measure = [float(res)] * 2
    jloss, tloss = JH1Loss(d=2, measure=measure), H1Loss(d=2, measure=measure)
    jgrads = jax.jit(jax.grad(lambda p: jloss(jm.apply({"params": p}, jnp.asarray(x)),
                                              jnp.asarray(y))))(params)
    tloss(got, torch.from_numpy(y)).backward()
    _check_grads(jgrads, tm)


@pytest.mark.parametrize("extra", [
    dict(domain_padding=0.25, diff_layers=(True, False), norm="group_norm"),
    dict(positional_embedding=None, disco_layers=False, output_shape=(24, 24)),
])
def test_local_no_options(jax_pallas, extra):
    extra = dict(extra)
    call = {"output_shape": extra.pop("output_shape")} if "output_shape" in extra else {}
    jm = jlocal.LocalNO(**_local_no_kwargs(**extra))
    x = _rand(5, 2, 1, 16, 16)
    params = _init(jm, jnp.asarray(x))
    tm = _load(LocalNO(**_local_no_kwargs(**extra), device="cpu"), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), **call))
    got = tm(torch.from_numpy(x), **call).detach().numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= MODEL_TOL


def test_local_no_is_registered_and_records_its_arguments():
    model = get_model({"model_arch": "LocalNO", **_local_no_kwargs()}, device="cpu")
    assert isinstance(model, LocalNO)
    assert model._init_kwargs["default_in_shape"] == (16, 16)
