"""The FNO family's layer options in the port against the JAX package.

Each flax module is initialised, its parameters go through the port's
converter into the port module, and both run the same numpy input; the JAX
side reaches the Pallas contraction in interpret mode (backend forced to
"pallas" and restored to "auto" afterwards). Gradients are the H1 loss's
against a seeded target, per parameter.

Tolerances, f32 throughout:
- elementwise helpers (mode gathers and scatters, padding, activations):
  equal to the bit, or ``rtol=1e-6, atol=1e-7`` for the activations'
  transcendental functions;
- modules: ``rtol=1e-5, atol=1e-6``; whole models: relative l2 <= 1e-5
  (2e-5 on the FFT path, where pocketfft and XLA's ducc FFT round apart);
- gradients: relative l2 <= 1e-4 per leaf (the card-against-CPU bound of
  a step), against the larger of the leaf's norm and 1% of the whole
  gradient's: bias gradients are sums that cancel (a conv bias before an
  instance norm has a zero gradient, in rounding noise);
- bfloat16 policies ("half", "mixed"): relative l2 <= 1e-2 against eager
  JAX (``jax.disable_jit``), the bf16 rounding of a few elements flipping
  where f32 sums run in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental import pallas as pl

from neuraloperator_tpu.layers import complex as jcomplex
from neuraloperator_tpu.layers import embeddings as jemb
from neuraloperator_tpu.layers import fno_block as jblk
from neuraloperator_tpu.layers import normalization_layers as jnorm
from neuraloperator_tpu.layers import padding as jpad
from neuraloperator_tpu.layers import resample as jres
from neuraloperator_tpu.layers import skip_connections as jskip
from neuraloperator_tpu.layers import spectral_convolution as jconv
from neuraloperator_tpu.losses import H1Loss as JH1Loss
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.ops import fourier as jfourier
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.layers import complex as tcomplex
from neuraloperator_tpu_torch.layers import embeddings as temb
from neuraloperator_tpu_torch.layers import normalization_layers as tnorm
from neuraloperator_tpu_torch.layers import padding as tpad
from neuraloperator_tpu_torch.layers import resample as tres
from neuraloperator_tpu_torch.layers.fno_block import FNOBlocks
from neuraloperator_tpu_torch.layers.skip_connections import LocalConvSkip
from neuraloperator_tpu_torch.layers.spectral_convolution import SpectralConv
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.models import FNO, get_model
from neuraloperator_tpu_torch.ops import fourier as tfourier

torch.set_num_threads(1)

MODULE_RTOL, MODULE_ATOL = 1e-5, 1e-6
MODEL_TOL, FFT_MODEL_TOL = 1e-5, 2e-5
GRAD_TOL = 1e-4
HALF_TOL = 1e-2


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _rand(seed, *shape, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.standard_normal(shape).astype(np.float32)).astype(np.complex64)
    return x


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _load(port_module, params):
    port_module.load_state_dict(
        convert.convert_flax_params(params, port_module.state_dict(), device="cpu"), strict=True)
    return port_module


def _real_channels(out, xp):
    """A complex output as real channels (real parts, then imaginary)."""
    if xp is torch:
        return torch.cat([out.real, out.imag], dim=1) if out.is_complex() else out
    return jnp.concatenate([out.real, out.imag], axis=1) if jnp.iscomplexobj(out) else out


def _target(seed, *shape):
    """A seeded target off zero mean, so that the biases' gradients (the
    spatial sums of the loss's gradient, where its derivative terms cancel)
    carry the loss's signal and not only its rounding."""
    return 1.0 + _rand(seed, *shape)


def _grads_close(jax_apply, params, port_module, port_call, x, y, d):
    """H1 gradients of the flax parameters against the port's, per leaf.

    The loss is taken on a grid of unit spacing (``measure`` = the sizes),
    so its value and derivative terms weigh alike: on a 600-point axis of
    the unit interval the derivative terms outweigh the value term some
    10^5-fold and the biases' gradients, the spatial sums of the loss's
    gradient, fall to the rounding of those terms' cancelling sums."""
    measure = [float(n) for n in y.shape[2:]]
    jloss, tloss = JH1Loss(d=d, measure=measure), H1Loss(d=d, measure=measure)

    def loss(p):
        return jloss(_real_channels(jax_apply(p, jnp.asarray(x)), jnp), jnp.asarray(y))

    jgrads = convert.flatten_flax(jax.jit(jax.grad(loss))(params))
    port_module.zero_grad()
    out = port_call(torch.from_numpy(x))
    tloss(_real_channels(out, torch), torch.from_numpy(y)).backward()
    tgrads = {n: p.grad for n, p in port_module.named_parameters()}
    assert set(tgrads) == set(jgrads)
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jgrads.values()))
    for name, ref in jgrads.items():
        ref = np.asarray(ref, np.float64)
        got = tgrads[name].detach().double().numpy()
        scale = max(np.linalg.norm(ref), 1e-2 * total)
        assert np.linalg.norm(got - ref) / scale <= GRAD_TOL, name


# ------------------------------------------------------------------ fourier ops


@pytest.mark.parametrize("shape,kept", [((2, 3, 8, 9), (4, 5)), ((2, 3, 7, 6), (7, 6)),
                                        ((1, 2, 5, 4), (9, 1))])
def test_gather_and_scatter_center_modes(shape, kept):
    x = _rand(0, *shape)
    axes = [-2, -1]
    want = np.asarray(jfourier.gather_center_modes(jnp.asarray(x), kept, axes))
    got = tfourier.gather_center_modes(torch.from_numpy(x), kept, axes).numpy()
    np.testing.assert_array_equal(got, want)
    out_sizes = [s + 3 for s in want.shape[-2:]]
    back = np.asarray(jfourier.scatter_center_modes(jnp.asarray(want), out_sizes, axes))
    np.testing.assert_array_equal(
        tfourier.scatter_center_modes(torch.from_numpy(want), out_sizes, axes).numpy(), back)
    same = list(want.shape[-2:])
    np.testing.assert_array_equal(
        tfourier.scatter_center_modes(torch.from_numpy(want), same, axes).numpy(),
        np.asarray(jfourier.scatter_center_modes(jnp.asarray(want), same, axes)))
    with pytest.raises(ValueError, match="target size"):
        tfourier.scatter_center_modes(torch.from_numpy(want), [1, 1], axes)


def test_scatter_low_modes_last():
    x = _rand(1, 2, 3, 5)
    for axis, size in ((-1, 9), (1, 6), (-1, 5)):
        np.testing.assert_array_equal(
            tfourier.scatter_low_modes_last(torch.from_numpy(x), size, axis).numpy(),
            np.asarray(jfourier.scatter_low_modes_last(jnp.asarray(x), size, axis)))


# ------------------------------------------------------------------ resample


@pytest.mark.parametrize("n_in,n_out,kind", [(8, 13, "linear"), (16, 32, "cubic"),
                                             (17, 9, "cubic"), (1, 4, "linear")])
def test_interp_matrix_is_the_jax_matrix(n_in, n_out, kind):
    np.testing.assert_array_equal(tres._interp_matrix(n_in, n_out, kind),
                                  jres._interp_matrix(n_in, n_out, kind))


@pytest.mark.parametrize("shape,scale,output_shape", [
    ((2, 3, 12), 1.5, None), ((2, 3, 12, 10), 2, None), ((2, 3, 16, 16), 1.0, (32, 24)),
    ((2, 3, 6, 8, 10), 0.5, None), ((1, 2, 8, 8, 8), 1.0, (12, 10, 9)),
])
def test_resample(shape, scale, output_shape):
    x = _rand(3, *shape)
    axes = list(range(2, len(shape)))
    want = np.asarray(jres.resample(jnp.asarray(x), scale, axes, output_shape=output_shape))
    got = tres.resample(torch.from_numpy(x), scale, axes, output_shape=output_shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_iterative_resample():
    """Axis by axis. The JAX function sizes each step from the trailing axes,
    so it resamples the last axis, or each axis of a 1-D signal; an earlier
    axis of a 2-D signal makes both packages raise."""
    x = _rand(4, 2, 3, 8, 12)
    for scale, axis, arr in ((2.0, 3, x), (0.75, [3], x), ([1.5], [2], x[..., 0])):
        want = np.asarray(jres.iterative_resample(jnp.asarray(arr), scale, axis))
        got = tres.iterative_resample(torch.from_numpy(np.ascontiguousarray(arr)), scale,
                                      axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        jres.iterative_resample(jnp.asarray(x), 2.0, [2, 3])
    with pytest.raises(RuntimeError):
        tres.iterative_resample(torch.from_numpy(x), 2.0, [2, 3])


# ------------------------------------------------------------------ small layers


@pytest.mark.parametrize("name", ["CGELU", "ctanh", "cselu"])
def test_complex_activations(name):
    z = _rand(5, 3, 4, 7, complex_=True)
    want = np.asarray(getattr(jcomplex, name)(jnp.asarray(z)))
    got = getattr(tcomplex, name)(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_complex_valued_channel_mlp():
    from neuraloperator_tpu.layers.channel_mlp import ChannelMLP as JMLP
    from neuraloperator_tpu_torch.layers import ChannelMLP

    z = _rand(6, 2, 4, 5, 6, complex_=True)
    flax_module = jcomplex.ComplexValued(
        module_factory=lambda: JMLP(in_channels=4, out_channels=3, hidden_channels=6))
    params = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
    assert sorted(params) == ["ChannelMLP_0", "ChannelMLP_1"]
    port = _load(tcomplex.ComplexValued(
        lambda: ChannelMLP(4, out_channels=3, hidden_channels=6, device="cpu")), params)
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(z)))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(z)).numpy(), want,
                                   rtol=MODULE_RTOL, atol=MODULE_ATOL)


def _norm_pair(kind):
    if kind == "instance":
        return jnorm.InstanceNorm(), tnorm.InstanceNorm()
    if kind == "group":
        return (jnorm.GroupNorm(num_groups=2, num_channels=6),
                tnorm.GroupNorm(2, 6, device="cpu"))
    return (jnorm.AdaIN(embed_dim=5, in_channels=6, mlp_hidden=16),
            tnorm.AdaIN(5, 6, mlp_hidden=16, device="cpu"))


# AdaIN's affine map is real: it is held on real data only
@pytest.mark.parametrize("kind,complex_", [("instance", False), ("group", False),
                                           ("ada_in", False), ("instance", True),
                                           ("group", True)])
def test_norms(kind, complex_):
    x = _rand(7, 3, 6, 5, 7, complex_=complex_)
    args = (jnp.asarray(_rand(8, 5)),) if kind == "ada_in" else ()
    flax_module, port = _norm_pair(kind)
    variables = flax_module.init(jax.random.PRNGKey(1), jnp.asarray(x), *args)
    params = variables.get("params", {})
    if params:
        # nonzero affine parameters, so that the test sees them
        params = jax.tree_util.tree_map(
            lambda p: p + 0.1 * jnp.asarray(_rand(9, *p.shape)), params)
        _load(port, params)
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x), *args))
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    with torch.no_grad():
        got = port(torch.from_numpy(x), *targs).numpy()
    np.testing.assert_allclose(got, want, rtol=MODULE_RTOL, atol=MODULE_ATOL)


def test_batch_norm_updates_its_running_statistics_as_flax():
    """The module against flax's apply with ``mutable=["batch_stats"]``: the
    output and the updated running mean and variance, over two calls, then
    the running-average forward."""
    flax_module = jnorm.BatchNorm(n_dim=2, num_features=4)
    port = tnorm.BatchNorm(2, 4, device="cpu")
    x0 = _rand(10, 3, 4, 5, 6)
    variables = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    params = jax.tree_util.tree_map(lambda p: p + 0.1 * jnp.asarray(_rand(11, *p.shape)),
                                    variables["params"])
    _load(port, params)
    stats = variables["batch_stats"]
    np.testing.assert_array_equal(port.mean.numpy(), np.asarray(stats["mean"]))
    np.testing.assert_array_equal(port.var.numpy(), np.asarray(stats["var"]))
    for seed in (12, 13):
        x = 2.0 + _rand(seed, 3, 4, 5, 6)
        want, updated = flax_module.apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x), mutable=["batch_stats"])
        stats = updated["batch_stats"]
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=MODULE_RTOL, atol=MODULE_ATOL)
        np.testing.assert_allclose(port.mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
        np.testing.assert_allclose(port.var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    x = _rand(14, 3, 4, 5, 6)
    want = flax_module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             use_running_average=True)
    got = port(torch.from_numpy(x), use_running_average=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=MODULE_RTOL, atol=MODULE_ATOL)
    # the statistics are flax's separate collection, not parameters
    assert set(port.state_dict()) == {"scale", "bias"}


@pytest.mark.parametrize("n_dim,k", [(1, 3), (2, 3), (2, 4), (2, 2), (3, 3), (1, 4)])
def test_local_conv_skip(n_dim, k):
    """lax's "SAME" padding, an even kernel's extra pad after, as torch pads it."""
    x = _rand(15, 2, 3, *(7, 6, 5)[:n_dim])
    flax_module = jskip.LocalConvSkip(in_channels=3, out_channels=4, n_dim=n_dim, kernel_size=k)
    params = flax_module.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    port = _load(LocalConvSkip(3, 4, n_dim, k, device="cpu"), params)
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, *x.shape[2:])
    np.testing.assert_allclose(got, want, rtol=MODULE_RTOL, atol=MODULE_ATOL)


def test_local_conv_skip_init_follows_the_jax_distribution():
    flax_module = jskip.LocalConvSkip(in_channels=32, out_channels=32, n_dim=2, kernel_size=3)
    j = np.asarray(flax_module.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 4, 4)))
                   ["params"]["kernel"], np.float64)
    t = LocalConvSkip(32, 32, 2, 3, device="cpu",
                      generator=torch.Generator().manual_seed(3)).kernel.detach().double()
    assert abs(t.std().item() / j.std() - 1) < 0.05
    bound = 2 * j.std() / 0.87962566103423978
    assert t.abs().max().item() <= bound * 1.06 and np.abs(j).max() <= bound * 1.06


@pytest.mark.parametrize("padding,scaling,shape", [
    (0.25, None, (2, 3, 16, 16)), ([0.1, 0.3], 2, (2, 3, 17, 12)),
    (0.125, [1.5, 0.5], (1, 2, 16, 20)), (0.2, 1, (1, 2, 9)), (1 / 3, 2.5, (1, 2, 7, 7)),
])
def test_domain_padding(padding, scaling, shape):
    x = _rand(16, *shape)
    jdp = jpad.DomainPadding(padding, resolution_scaling_factor=scaling)
    tdp = tpad.DomainPadding(padding, resolution_scaling_factor=scaling)
    padded = np.asarray(jdp.pad(jnp.asarray(x)))
    np.testing.assert_array_equal(tdp.pad(torch.from_numpy(x)).numpy(), padded)
    n_dim = len(shape) - 2
    rsf = scaling if isinstance(scaling, list) else [scaling or 1] * n_dim
    scaled = np.asarray(jres.resample(jnp.asarray(padded), rsf, list(range(2, padded.ndim))))
    for y in (scaled, padded[..., 1:]):  # the search and its fallback
        np.testing.assert_array_equal(tdp.unpad(torch.from_numpy(y)).numpy(),
                                      np.asarray(jdp.unpad(jnp.asarray(y))))


def test_grid_embedding_2d():
    x = _rand(17, 2, 3, 9, 7)
    boundaries = ((0.0, 2.0), (-1.0, 1.0))
    want = np.asarray(jemb.GridEmbedding2D(3, grid_boundaries=boundaries)(jnp.asarray(x)))
    got = temb.GridEmbedding2D(3, grid_boundaries=boundaries)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in zip(temb.regular_grid_2d((5, 6)), jemb.regular_grid_2d((5, 6))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ SpectralConv


CONV_CASES = {
    # the rFFT/irFFT branch: a last axis over 512 points (1-D keeps it cheap)
    "fft_1d": (dict(n_modes=(12,)), (2, 4, 600), {}),
    "fft_2d": (dict(n_modes=(4, 6)), (1, 3, 6, 520), {}),
    "fft_no_hermitian": (dict(n_modes=(12,), enforce_hermitian_symmetry=False), (2, 4, 600), {}),
    "no_hermitian": (dict(n_modes=(6, 6), enforce_hermitian_symmetry=False), (2, 4, 8, 10), {}),
    "complex_2d": (dict(n_modes=(6, 5), complex_data=True), (2, 4, 8, 7), {}),
    "complex_1d_max_modes": (dict(n_modes=(5,), max_n_modes=(9,), complex_data=True),
                             (2, 4, 12), {}),
    "complex_output_shape": (dict(n_modes=(6, 6), complex_data=True), (2, 4, 8, 8),
                             {"output_shape": (5, 12)}),
    "scaling": (dict(n_modes=(6, 6), resolution_scaling_factor=2), (2, 4, 8, 9), {}),
    "scaling_down": (dict(n_modes=(6, 6), resolution_scaling_factor=[0.5, 1.5]),
                     (2, 4, 12, 10), {}),
    "output_shape": (dict(n_modes=(6, 6)), (2, 4, 8, 8), {"output_shape": (16, 13)}),
    "fft_output_shape": (dict(n_modes=(8,)), (2, 4, 300), {"output_shape": (700,)}),
    "n_modes_call": (dict(n_modes=(8, 8)), (2, 4, 12, 12), {"n_modes": (4, 6)}),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_spectral_conv_options(jax_pallas, case):
    kwargs, shape, call = CONV_CASES[case]
    complex_ = kwargs.get("complex_data", False)
    x = _rand(20, *shape, complex_=complex_)
    flax_module = jconv.SpectralConv(shape[1], 3, **kwargs)
    params = flax_module.init(jax.random.PRNGKey(4), jnp.asarray(x), **call)["params"]
    port = _load(SpectralConv(shape[1], 3, **kwargs, device="cpu"), params)
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x), **call))
    got = port(torch.from_numpy(x), **call).detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = FFT_MODEL_TOL if shape[-1] > 512 or call.get("output_shape", (0,))[-1] > 512 \
        else MODEL_TOL
    assert _rel_l2(got, want) <= tol
    y = _target(21, *want.shape[:1], 2 * want.shape[1] if complex_ else want.shape[1],
              *want.shape[2:])
    _grads_close(lambda p, xx: flax_module.apply({"params": p}, xx, **call), params, port,
                 lambda xx: port(xx, **call), x, y, d=len(shape) - 2)


@pytest.mark.parametrize("precision", ["half", "mixed"])
@pytest.mark.parametrize("case", ["fft_1d", "complex_2d"])
def test_spectral_conv_bf16_roundings_on_the_fft_branches(jax_pallas, precision, case):
    """The rFFT in f32 rounded to bf16 after the slice, and the complex
    spectrum rounded whole, against eager JAX."""
    kwargs, shape, _ = CONV_CASES[case]
    complex_ = kwargs.get("complex_data", False)
    x = _rand(22, *shape, complex_=complex_)
    flax_module = jconv.SpectralConv(shape[1], 3, fno_block_precision=precision, **kwargs)
    with jax.disable_jit():
        params = flax_module.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
        want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x)).astype(
            jnp.float32))
    port = _load(SpectralConv(shape[1], 3, fno_block_precision=precision, **kwargs,
                              device="cpu"), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), want) <= HALF_TOL


# ------------------------------------------------------------------ FNOBlocks


class _FlaxStack(fnn.Module):
    """Runs every layer of a flax FNOBlocks, so that all get parameters."""

    kwargs: dict
    n_layers: int = 2

    @fnn.compact
    def __call__(self, x, embedding=None, output_shape=None):
        blocks = jblk.FNOBlocks(in_channels=6, out_channels=6, n_modes=(6, 5),
                                n_layers=self.n_layers, name="blocks", **self.kwargs)
        shapes = [None] * (self.n_layers - 1) + [output_shape]
        for i in range(self.n_layers):
            x = blocks(x, i, shapes[i], embedding)
        return x


BLOCK_CASES = {
    "instance_norm": dict(norm="instance_norm"),
    "group_norm": dict(norm="group_norm", norm_groups=2),
    "ada_in": dict(norm="ada_in", ada_in_features=5),
    "preactivation": dict(preactivation=True, norm="group_norm", norm_groups=3),
    "stabilizer": dict(stabilizer="tanh"),
    "conv_bias_kernel": dict(conv_bias_kernel=3),
    "complex_data": dict(complex_data=True),
    "complex_preactivation_stabilizer": dict(complex_data=True, preactivation=True,
                                             stabilizer="tanh", conv_bias_kernel=2),
    "scaling_per_layer": dict(resolution_scaling_factor=[1.5, 2]),
    "identity_skips": dict(fno_skip="identity", channel_mlp_skip="identity"),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_fno_blocks_options(jax_pallas, case):
    kwargs = BLOCK_CASES[case]
    complex_ = kwargs.get("complex_data", False)
    x = _rand(23, 2, 6, 8, 9, complex_=complex_)
    emb = jnp.asarray(_rand(24, 5)) if kwargs.get("norm") == "ada_in" else None
    flax_module = _FlaxStack(kwargs=kwargs)
    params = flax_module.init(jax.random.PRNGKey(6), jnp.asarray(x), emb)["params"]
    port = _load(FNOBlocks(6, 6, (6, 5), n_layers=2, **kwargs, device="cpu"),
                 params["blocks"])
    temb_ = None if emb is None else torch.from_numpy(np.asarray(emb))

    def port_call(xx):
        for i in range(2):
            xx = port(xx, i, ada_in_embedding=temb_)
        return xx

    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x), emb))
    got = port_call(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel_l2(got, want) <= MODEL_TOL
    y = _target(25, 2, 12 if complex_ else 6, *want.shape[2:])
    port_params = [port]

    def jax_apply(p, xx):
        return flax_module.apply({"params": {"blocks": p}}, xx, emb)

    _grads_close(jax_apply, params["blocks"], port_params[0], port_call, x, y, d=2)


def test_fno_blocks_output_shape_resamples_the_skips(jax_pallas):
    x = _rand(26, 2, 6, 8, 8)
    flax_module = _FlaxStack(kwargs={})
    params = flax_module.init(jax.random.PRNGKey(7), jnp.asarray(x), None, (13, 16))["params"]
    port = _load(FNOBlocks(6, 6, (6, 5), n_layers=2, device="cpu"), params["blocks"])
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x), None, (13, 16)))
    with torch.no_grad():
        h = port(torch.from_numpy(x), 0)
        got = port(h, 1, (13, 16)).numpy()
    assert got.shape == (2, 6, 13, 16)
    assert _rel_l2(got, want) <= MODEL_TOL


def test_fno_blocks_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="conv_bias_kernel"):
        FNOBlocks(4, 4, (4, 4), fno_skip="soft-gating", conv_bias_kernel=3, device="cpu")
    with pytest.raises(ValueError, match="norm="):
        FNOBlocks(4, 4, (4, 4), norm="layer_norm", device="cpu")
    blocks = FNOBlocks(4, 4, (4, 4), norm="ada_in", ada_in_features=3, device="cpu")
    with pytest.raises(ValueError, match="ada_in_embedding"):
        blocks(torch.zeros(1, 4, 8, 8), 0)


# ------------------------------------------------------------------ FNO


FNO_CASES = {
    "domain_padding": dict(domain_padding=0.25),
    "domain_padding_per_dim_scaled": dict(domain_padding=[0.125, 0.25],
                                          resolution_scaling_factor=[1, 1.5]),
    "complex_data": dict(complex_data=True),
    "scaling_per_layer": dict(resolution_scaling_factor=[2, 0.5]),
    "norm_preactivation_stabilizer": dict(norm="instance_norm", preactivation=True,
                                          stabilizer="tanh"),
    "conv_bias_kernel": dict(conv_bias_kernel=3, norm="group_norm"),
    "no_embedding_fft_path": dict(positional_embedding=None),
}


def _fno_pair(seed, **kwargs):
    common = dict(n_modes=(6, 6), in_channels=1, out_channels=1, hidden_channels=6)
    kwargs.setdefault("n_layers", 2)
    jkw = dict(kwargs)
    for key in ("domain_padding", "resolution_scaling_factor"):
        if isinstance(jkw.get(key), list):
            jkw[key] = tuple(jkw[key])
    return jfno.FNO(**common, **jkw), FNO(**common, **kwargs, device="cpu")


@pytest.mark.parametrize("case", sorted(FNO_CASES))
def test_fno_options(jax_pallas, case):
    kwargs = dict(FNO_CASES[case])
    complex_ = kwargs.get("complex_data", False)
    shape = (2, 1, 8, 600) if case.endswith("fft_path") else (2, 1, 10, 12)
    x = _rand(27, *shape, complex_=complex_)
    flax_module, port = _fno_pair(8, **kwargs)
    params = flax_module.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"]
    _load(port, params)
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel_l2(got, want) <= (FFT_MODEL_TOL if shape[-1] > 512 else MODEL_TOL)
    y = _target(28, 2, 2 if complex_ else 1, *want.shape[2:])
    _grads_close(lambda p, xx: flax_module.apply({"params": p}, xx), params, port, port,
                 x, y, d=2)


@pytest.mark.parametrize("output_shape,n_modes", [
    ((24, 20), None), ([(12, 12), (16, 20)], None), (None, (4, 4)), ((12, 16), (4, 6)),
])
def test_fno_per_call_output_shape_and_n_modes(jax_pallas, output_shape, n_modes):
    """A tuple sizes the last layer's output, a list each layer's; ``n_modes``
    takes the centre of the stored weights."""
    x = _rand(29, 2, 1, 10, 12)
    flax_module, port = _fno_pair(9, domain_padding=0.2)
    params = flax_module.init(jax.random.PRNGKey(9), jnp.asarray(x))["params"]
    _load(port, params)
    jshape = [tuple(s) for s in output_shape] if isinstance(output_shape, list) else output_shape
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x), jshape, n_modes))
    got = port(torch.from_numpy(x), output_shape, n_modes).detach().numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= MODEL_TOL
    y = _target(30, *want.shape)
    _grads_close(lambda p, xx: flax_module.apply({"params": p}, xx, jshape, n_modes), params,
                 port, lambda xx: port(xx, output_shape, n_modes), x, y, d=2)


def test_fno_takes_an_embedding_instance_with_the_jax_checks(jax_pallas):
    boundaries = ((0.0, 2.0), (0.0, 1.0))
    x = _rand(31, 2, 1, 8, 10)
    flax_module = jfno.FNO(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=6,
                           n_layers=2,
                           positional_embedding=jemb.GridEmbedding2D(1, boundaries))
    port = FNO((4, 4), 1, 1, 6, n_layers=2, device="cpu",
               positional_embedding=temb.GridEmbedding2D(1, boundaries))
    params = flax_module.init(jax.random.PRNGKey(10), jnp.asarray(x))["params"]
    _load(port, params)
    want = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        assert _rel_l2(port(torch.from_numpy(x)).numpy(), want) <= MODEL_TOL
    with pytest.raises(ValueError, match="2-d"):
        FNO((4,), 1, 1, 4, positional_embedding=temb.GridEmbedding2D(1), device="cpu")
    with pytest.raises(ValueError, match="positional_embedding"):
        FNO((4, 4), 1, 1, 4, positional_embedding="sinusoidal", device="cpu")
    nd = FNO((4,), 1, 1, 4, positional_embedding=temb.GridEmbeddingND(1, dim=1), device="cpu")
    assert nd(torch.zeros(1, 1, 8)).shape == (1, 1, 8)


def test_fno_refuses_what_jax_refuses():
    """ada_in at the model level: the JAX FNO passes no ``ada_in_features``
    to its blocks, so neither package can build the norm's MLP; scan_layers
    keeps JAX's ValueErrors."""
    x = jnp.zeros((1, 1, 8, 8))
    with pytest.raises(TypeError):
        jfno.FNO(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=4,
                 n_layers=1, norm="ada_in").init(jax.random.PRNGKey(0), x,
                                                 ada_in_embedding=jnp.ones(3))
    with pytest.raises(TypeError, match="ada_in_features"):
        FNO((4, 4), 1, 1, 4, n_layers=1, norm="ada_in", device="cpu")
    for option in ({"norm": "group_norm"}, {"domain_padding": 0.0, "stabilizer": "tanh"},
                   {"complex_data": True}, {"resolution_scaling_factor": 2},
                   {"conv_bias_kernel": 3}, {"preactivation": True}):
        with pytest.raises(ValueError, match="scan_layers=True does not support"):
            FNO((4, 4), 1, 1, 4, scan_layers=True, device="cpu", **option)


def test_get_model_passes_domain_padding_and_norm():
    from neuraloperator_tpu.models import get_model as jget_model

    config = {"model": {"model_arch": "fno", "data_channels": 1, "out_channels": 1,
                        "n_modes": [4, 4], "hidden_channels": 6, "n_layers": 2,
                        "domain_padding": 0.25, "norm": "group_norm"}}
    model = get_model(config, device="cpu")
    assert model.domain_padding is not None and model.domain_padding.domain_padding == 0.25
    assert isinstance(model.fno_blocks.norm_3, tnorm.GroupNorm)
    jmodel = jget_model(config)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 8, 8)))["params"]
    convert.check_flax_params(params, model.state_dict())


def test_checkpoints_of_the_new_leaves_cross_both_ways(tmp_path):
    """Norm scales and biases, AdaIN's dense layers, the local convolution's
    OIHW kernel and the complex lifting and projection, written by each
    package's training-state writer and read by the other's."""
    from neuraloperator_tpu.training import training_state as jstate
    from neuraloperator_tpu_torch.training import training_state as tstate

    kwargs = dict(complex_data=True, conv_bias_kernel=3, norm="group_norm", n_layers=2)
    flax_module, port = _fno_pair(11, **kwargs)
    x = _rand(32, 1, 1, 8, 8, complex_=True)
    params = flax_module.init(jax.random.PRNGKey(11), jnp.asarray(x))["params"]
    flat = convert.flatten_flax(params)
    assert {"lifting.ChannelMLP_1.w0", "projection.ChannelMLP_0.b1",
            "fno_blocks.fno_skip_1.LocalConvSkip_0.kernel",
            "fno_blocks.norm_3.scale"} <= set(flat)
    jstate.save_training_state(tmp_path / "jax", "model", params, None, epoch=0)
    state, _, _ = tstate.load_training_state(tmp_path / "jax", "model", port.state_dict(),
                                             device="cpu")
    port.load_state_dict(state)
    for name, leaf in flat.items():
        np.testing.assert_array_equal(port.state_dict()[name].numpy(), np.asarray(leaf))
    with torch.no_grad():
        for p in port.parameters():
            p.add_(1.0)
    tstate.save_training_state(tmp_path / "port", "model", port.state_dict(), epoch=0)
    back, _, _ = jstate.load_training_state(tmp_path / "port", "model", params, None)
    for name, leaf in convert.flatten_flax(back).items():
        np.testing.assert_array_equal(np.asarray(leaf), port.state_dict()[name].numpy())
