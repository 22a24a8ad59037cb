"""The port's FNO modules against the flax modules of the JAX package.

Each flax module is initialised, its parameters go through the port's
converter into the port module, and both run the same numpy input. The
JAX side reaches the Pallas contraction (interpret mode, backend forced to
"pallas" and restored to "auto" afterwards).

Tolerances: f32 ``rtol=1e-5, atol=1e-6`` per module; relative l2 <= 1e-5
for the whole FNO. Init distributions: sample std within 5% of the JAX
init's, and the same truncation bound.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.experimental import pallas as pl

from neuraloperator_tpu.layers import channel_mlp as jmlp
from neuraloperator_tpu.layers import embeddings as jemb
from neuraloperator_tpu.layers import fno_block as jblk
from neuraloperator_tpu.layers import skip_connections as jskip
from neuraloperator_tpu.layers import spectral_convolution as jconv
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.layers import (
    ChannelMLP,
    FNOBlocks,
    Flattened1dConv,
    GridEmbeddingND,
    SoftGating,
    SpectralConv,
)
from neuraloperator_tpu_torch.models import FNO, model_from_metadata

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
METADATA = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2/model_metadata.json"


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run_both(flax_module, port_module, x, *args):
    """Init flax on x, load its params into the port module, run both."""
    variables = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), *args)
    params = variables.get("params", {})
    state = convert.convert_flax_params(params, port_module.state_dict(), device="cpu")
    port_module.load_state_dict(state, strict=True)
    expected = np.asarray(flax_module.apply(variables, jnp.asarray(x), *args))
    with torch.no_grad():
        actual = port_module(torch.from_numpy(x), *args).numpy()
    return actual, expected


def _close(actual, expected):
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "n_modes,max_n_modes,res",
    [((8, 8), None, (16, 16)), ((6, 5), None, (17, 33)), ((6, 5), (9, 4), (16, 17))],
)
def test_spectral_conv(jax_pallas, n_modes, max_n_modes, res):
    x = _rand(0, 2, 6, *res)
    actual, expected = _run_both(
        jconv.SpectralConv(6, 10, n_modes, max_n_modes=max_n_modes),
        SpectralConv(6, 10, n_modes, max_n_modes=max_n_modes, device="cpu"),
        x,
    )
    _close(actual, expected)


def test_channel_mlp():
    x = _rand(1, 2, 6, 9, 17)
    actual, expected = _run_both(
        jmlp.ChannelMLP(in_channels=6, out_channels=5, hidden_channels=12),
        ChannelMLP(6, out_channels=5, hidden_channels=12, device="cpu"),
        x,
    )
    _close(actual, expected)


@pytest.mark.parametrize("use_bias", [False, True])
def test_soft_gating(use_bias):
    x = _rand(2, 2, 6, 9, 17)
    port = SoftGating(6, 6, n_dim=2, use_bias=use_bias, device="cpu")
    with torch.no_grad():
        for p in port.parameters():
            p.copy_(torch.from_numpy(_rand(3, *p.shape)))
    flax_module = jskip.SoftGating(in_features=6, out_features=6, n_dim=2, use_bias=use_bias)
    params = {name: p.detach().numpy() for name, p in port.named_parameters()}
    expected = np.asarray(flax_module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), expected)


@pytest.mark.parametrize("use_bias", [False, True])
def test_flattened_1d_conv(use_bias):
    x = _rand(4, 3, 6, 8, 11)
    actual, expected = _run_both(
        jskip.Flattened1dConv(in_channels=6, out_channels=9, use_bias=use_bias),
        Flattened1dConv(6, 9, use_bias=use_bias, device="cpu"),
        x,
    )
    _close(actual, expected)


@pytest.mark.parametrize("res", [(16, 16), (17, 33)])
def test_grid_embedding(res):
    x = _rand(5, 2, 1, *res)
    expected = np.asarray(jemb.GridEmbeddingND(1, dim=2)(jnp.asarray(x)))
    actual = GridEmbeddingND(1, dim=2)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(actual, expected)


class _FlaxStack(fnn.Module):
    """Runs every layer of a flax FNOBlocks, so that all get parameters."""

    n_layers: int

    @fnn.compact
    def __call__(self, x):
        blocks = jblk.FNOBlocks(
            in_channels=8, out_channels=8, n_modes=(6, 5), n_layers=self.n_layers,
            name="blocks",
        )
        for i in range(self.n_layers):
            x = blocks(x, i)
        return x


def test_fno_blocks(jax_pallas):
    x = _rand(6, 2, 8, 16, 17)
    flax_module = _FlaxStack(n_layers=2)
    variables = flax_module.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = FNOBlocks(8, 8, (6, 5), n_layers=2, device="cpu")
    port.load_state_dict(convert.convert_flax_params(
        variables["params"]["blocks"], port.state_dict(), device="cpu"
    ))
    expected = np.asarray(flax_module.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        h = torch.from_numpy(x)
        for i in range(2):
            h = port(h, i)
    _close(h.numpy(), expected)


def _small_flagship(**overrides):
    """The flagship metadata cut to a small width and depth."""
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[8, 8], hidden_channels=12, n_layers=2, **overrides)
    return meta


def _jax_fno(meta):
    kwargs = {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["init_kwargs"].items()
        if not (isinstance(v, dict) and ("__callable__" in v or "__class__" in v))
    }
    return jfno.FNO(**kwargs)


@pytest.mark.parametrize("res", [(16, 16), (17, 33)])
def test_whole_fno(jax_pallas, res):
    meta = _small_flagship()
    x = _rand(7, 3, 1, *res)
    actual, expected = _run_both(_jax_fno(meta), model_from_metadata(meta, device="cpu"), x)
    assert actual.shape == (3, 1, *res)
    rel_l2 = np.linalg.norm(actual - expected) / np.linalg.norm(expected)
    assert rel_l2 <= 1e-5


def test_converter_covers_the_flagship_tree():
    """Every leaf of the full-width flagship maps to a port parameter of its shape."""
    meta = json.loads(METADATA.read_text())
    shapes = jax.eval_shape(
        _jax_fno(meta).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 1, 128, 128), jnp.float32),
    )["params"]
    port_state = model_from_metadata(meta, device="meta").state_dict()
    assert len(port_state) == len(convert.flatten_flax(shapes)) == 40
    convert.check_flax_params(shapes, port_state)
    n_params = sum(v.numel() for v in port_state.values())
    assert n_params == sum(int(np.prod(v.shape)) for v in convert.flatten_flax(shapes).values())


def test_converter_raises_on_leftover_leaves():
    port = FNO((6, 5), 1, 1, 8, n_layers=1, device="cpu")
    params = {}
    for name, p in port.state_dict().items():
        node = params
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.numpy()
    convert.check_flax_params(params, port.state_dict())
    with pytest.raises(ValueError, match="without a port name"):
        convert.check_flax_params({**params, "extra": np.zeros(3)}, port.state_dict())
    del params["projection"]["b1"]
    with pytest.raises(ValueError, match="without a flax leaf"):
        convert.check_flax_params(params, port.state_dict())
    params["projection"]["b1"] = np.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        convert.check_flax_params(params, port.state_dict())


def _std_and_max(a):
    a = np.asarray(a, np.float64)
    return a.std(), np.abs(a).max()


@pytest.mark.parametrize(
    "flax_module,port_module,x_shape,names",
    [
        (jconv.SpectralConv(16, 16, (8, 8)),
         lambda g: SpectralConv(16, 16, (8, 8), device="cpu", generator=g),
         (1, 16, 16, 16), ["w_weight"]),
        (jmlp.ChannelMLP(in_channels=64, out_channels=64, hidden_channels=256),
         lambda g: ChannelMLP(64, 64, 256, device="cpu", generator=g),
         (1, 64, 2, 2), ["w0", "w1"]),
        (jskip.Flattened1dConv(in_channels=128, out_channels=96),
         lambda g: Flattened1dConv(128, 96, device="cpu", generator=g),
         (1, 128, 2, 2), ["weight"]),
    ],
)
def test_init_follows_the_jax_distributions(flax_module, port_module, x_shape, names):
    jparams = flax_module.init(jax.random.PRNGKey(3), jnp.zeros(x_shape))["params"]
    tparams = dict(port_module(torch.Generator().manual_seed(3)).named_parameters())
    for name in names:
        j_std, j_max = _std_and_max(jparams[name])
        t_std, t_max = _std_and_max(tparams[name].detach())
        assert abs(t_std / j_std - 1) < 0.05, name
        if name != "w_weight":  # lecun_normal is truncated at 2 std
            bound = 2 * j_std / 0.87962566103423978
            assert t_max <= bound * 1.06 and j_max <= bound * 1.06, name


def test_unported_options_raise():
    # the block precisions and bf16 weight storage are ported
    # (tests/test_torch_mixed_precision.py holds them to JAX); unknown values raise
    conv = SpectralConv(4, 4, (4, 4), fno_block_precision="mixed", weight_dtype="bfloat16",
                        device="cpu")
    assert conv.w_weight.dtype == torch.bfloat16 and conv.bias.dtype == torch.float32
    with pytest.raises(ValueError, match="fno_block_precision"):
        SpectralConv(4, 4, (4, 4), fno_block_precision="quarter", device="cpu")
    with pytest.raises(ValueError, match="weight_dtype"):
        SpectralConv(4, 4, (4, 4), weight_dtype="float16", device="cpu")
    # scan_layers is ported (tests/test_torch_scan_remat.py holds it to JAX)
    scanned = FNO((4, 4), 1, 1, 4, scan_layers=True, device="cpu")
    assert scanned(torch.zeros(1, 1, 8, 8)).shape == (1, 1, 8, 8)
    # factorized weights are ported (tests/test_torch_tfno.py holds them to JAX)
    tucker = FNO((4, 4), 1, 1, 4, factorization="tucker", device="cpu")
    assert tucker.fno_blocks.conv_0.spec.kind == "tucker"
    assert tucker(torch.zeros(1, 1, 8, 8)).shape == (1, 1, 8, 8)
    # the FFT path is ported (tests/test_torch_layer_options.py holds it to
    # JAX): an earlier axis of any size takes the DFT matmul, a last axis
    # over 512 points the rFFT
    conv = SpectralConv(2, 2, (4, 4), device="cpu")
    assert conv(torch.zeros(1, 2, 520, 8)).shape == (1, 2, 520, 8)
    assert conv(torch.zeros(1, 2, 8, 520)).shape == (1, 2, 8, 520)
    # FNOBlocks takes any convolution class, as in JAX: the SFNO's
    # SphericalConv is ported (tests/test_torch_sfno.py holds it to JAX)
    from neuraloperator_tpu_torch.layers.spherical_convolution import SphericalConv

    spherical = FNOBlocks(4, 4, (4, 8), conv_module=SphericalConv, device="cpu")
    assert isinstance(spherical.conv_0, SphericalConv)
    assert spherical(torch.zeros(1, 4, 8, 16)).shape == (1, 4, 8, 16)


@pytest.mark.parametrize("n_modes,res", [((8,), (32,)), ((4, 4, 4), (8, 9, 10))],
                         ids=["1d", "3d"])
def test_whole_fno_in_1d_and_3d(jax_pallas, n_modes, res):
    """The flagship's options on a 1-D grid of 32 points and a 3-D grid of
    8x9x10: within relative l2 2e-6 of JAX. A CPU probe of both packages
    read 4e-7 at these shapes; over 6 input seeds at hidden 8 and 12 the
    1-D forward reads up to 1.0e-6 (f32 sums in another order), the 3-D
    one up to 5.0e-7."""
    meta = _small_flagship()
    meta["init_kwargs"]["n_modes"] = list(n_modes)
    x = _rand(8, 2, 1, *res)
    actual, expected = _run_both(_jax_fno(meta), model_from_metadata(meta, device="cpu"), x)
    assert actual.shape == (2, 1, *res)
    assert np.linalg.norm(actual - expected) / np.linalg.norm(expected) <= 2e-6


@pytest.mark.parametrize("n_modes,res,options", [
    ((8,), (32,), {}), ((4, 4, 4), (8, 9, 10), {}),
    ((8,), (600,), {"domain_padding": 0.125}), ((4, 4, 4), (8, 8, 8), {"complex_data": True}),
], ids=["1d", "3d", "1d_fft_padded", "3d_complex"])
def test_whole_fno_gradients_in_1d_and_3d(jax_pallas, n_modes, res, options):
    """H1 gradients of the whole FNO on a 1-D and a 3-D grid (the latter also
    with complex data, the former on the rFFT path with domain padding):
    relative l2 <= 1e-4 per leaf against the larger of its norm and 1% of
    the whole gradient's, on a grid of unit spacing (the loss's value and
    derivative terms weigh alike). The re-anchor probe read 1.6e-5 (1-D)
    and 3.2e-6 (3-D) per leaf."""
    from neuraloperator_tpu.losses import H1Loss as JH1Loss
    from neuraloperator_tpu_torch.losses import H1Loss

    kwargs = dict(n_modes=n_modes, in_channels=1, out_channels=1, hidden_channels=6,
                  n_layers=2, **options)
    flax_module, port = jfno.FNO(**kwargs), FNO(**kwargs, device="cpu")
    x = _rand(9, 2, 1, *res)
    if options.get("complex_data"):
        x = (x + 1j * _rand(10, 2, 1, *res)).astype(np.complex64)
    params = flax_module.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    port.load_state_dict(convert.convert_flax_params(params, port.state_dict(), device="cpu"))
    channels = 2 if options.get("complex_data") else 1
    y = 1.0 + _rand(11, 2, channels, *res)
    measure = [float(n) for n in res]
    jloss, tloss = JH1Loss(d=len(res), measure=measure), H1Loss(d=len(res), measure=measure)

    def real(out, cat):
        return cat([out.real, out.imag]) if channels == 2 else out

    def loss(p):
        out = flax_module.apply({"params": p}, jnp.asarray(x))
        return jloss(real(out, lambda a: jnp.concatenate(a, axis=1)), jnp.asarray(y))

    jgrads = convert.flatten_flax(jax.jit(jax.grad(loss))(params))
    out = port(torch.from_numpy(x))
    tloss(real(out, lambda a: torch.cat(a, dim=1)), torch.from_numpy(y)).backward()
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                        for g in jgrads.values()))
    for name, p in port.named_parameters():
        ref = np.asarray(jgrads[name], np.float64)
        err = np.linalg.norm(p.grad.double().numpy() - ref) / max(np.linalg.norm(ref),
                                                                  1e-2 * total)
        assert err <= 1e-4, name
