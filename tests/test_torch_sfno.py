"""The port's SFNO family against the JAX package: ``SphericalConv``,
``FNOBlocks(conv_module=SphericalConv)``, the ``SFNO`` model, the SWE
generator and ``cosine_annealing``.

Each flax module is initialised, its parameters go through the port's
converter into the port module, and both run the same numpy input.

Tolerances:
* forwards in f32: relative l2 <= 2e-6. A CPU probe read 1.1e-7 to 1.7e-7
  for every ``SphericalConv`` case, 3.0e-7 for the recorded SFNO; JAX's
  own jitted and eager layers differ by up to 8.1e-8;
* gradients (of the input and of every parameter, against a random
  cotangent): relative l2 <= 1e-5 per leaf (the probe: 4.5e-7 at most);
* the SWE generator: relative l2 <= 1e-6 per array (the probe: 2.1e-7
  for the loaders' splits, 5.9e-7 at most for the map-style items: f32
  SHTs summed in another order, then a complex128 step);
* ``cosine_annealing``: its tensor form equal to optax's f32 value, its
  int form (float64 arithmetic) within f32 rounding of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuraloperator_tpu.config import SFNO_Small2d as JSFNO_Small2d
from neuraloperator_tpu.data.datasets import spherical_swe as jswe
from neuraloperator_tpu.layers.fno_block import FNOBlocks as JFNOBlocks
from neuraloperator_tpu.layers.spherical_convolution import SphericalConv as JSphericalConv
from neuraloperator_tpu.models import SFNO as JSFNO
from neuraloperator_tpu.models import get_model as jget_model
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.config import SFNO_Small2d
from neuraloperator_tpu_torch.data.datasets import spherical_swe as tswe
from neuraloperator_tpu_torch.layers.fno_block import FNOBlocks
from neuraloperator_tpu_torch.layers.spectral_convolution import SpectralConv
from neuraloperator_tpu_torch.layers.spherical_convolution import SphericalConv
from neuraloperator_tpu_torch.models import SFNO, get_model, model_from_metadata
from neuraloperator_tpu_torch.models.base_model import save_arch_metadata
from neuraloperator_tpu_torch.training import cosine_annealing

torch.set_num_threads(1)

F32_TOL = 2e-6
GRAD_TOL = 1e-5
DATA_TOL = 1e-6
# the recorded configuration (scripts/train_sfno_swe.py)
RECORDED = dict(n_modes=(16, 32), in_channels=3, out_channels=3, hidden_channels=64, n_layers=2,
                domain_padding=0.05)
RECORDED_PARAMS = 296_707


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _load(port_module, params):
    port_module.load_state_dict(
        convert.convert_flax_params(params, port_module.state_dict(), device="cpu"))
    return port_module


def _forward_and_grads(jmodule, tmodule, x, call=None, init_call=None):
    """Both modules on ``x`` from the JAX init: (port out, JAX out, port
    grads, JAX grads), grads of ``sum(out * g)`` for a random ``g``, by the
    port's parameter names plus ``"x"``."""
    call = call or {}
    params = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x), **(init_call or call))["params"]
    _load(tmodule, params)
    expected = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x), **call))
    g = _rand(99, *expected.shape)

    def loss(p, x):
        return jnp.sum(jmodule.apply({"params": p}, x, **call) * g)

    jgrads, jdx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmodule(xt, **call)
    (out * torch.from_numpy(g)).sum().backward()
    tgrads = {name: p.grad.numpy() for name, p in tmodule.named_parameters()}
    tgrads["x"] = xt.grad.numpy()
    jflat = {k: np.asarray(v) for k, v in convert.flatten_flax(jgrads).items()}
    jflat["x"] = np.asarray(jdx)
    return out.detach().numpy(), expected, tgrads, jflat


def _check(out, expected, tgrads, jgrads):
    assert out.shape == expected.shape
    assert _rel_l2(out, expected) <= F32_TOL
    assert tgrads.keys() == jgrads.keys()
    for name, g in jgrads.items():
        assert _rel_l2(tgrads[name], g) <= GRAD_TOL, name


CASES = {
    "dense": dict(factorization="dense"),
    "separable": dict(factorization="dense", separable=True),
    "cp-factorized": dict(factorization="cp", implementation="factorized"),
    "cp-reconstructed": dict(factorization="cp", implementation="reconstructed"),
    "tucker-factorized": dict(factorization="tucker", implementation="factorized"),
    "tucker-reconstructed": dict(factorization="tucker", implementation="reconstructed"),
    "tt-factorized": dict(factorization="tt", implementation="factorized"),
    "tt-reconstructed": dict(factorization="tt", implementation="reconstructed"),
    "separable-tucker": dict(factorization="tucker", separable=True, implementation="factorized"),
}


@pytest.mark.parametrize("case", CASES)
def test_spherical_conv_matches_jax(case):
    kwargs = CASES[case]
    out_channels = 4 if kwargs.get("separable") else 6
    jm = JSphericalConv(4, out_channels, (8, 12), rank=0.5, **kwargs)
    tm = SphericalConv(4, out_channels, (8, 12), rank=0.5, device="cpu", **kwargs)
    spec = jm.spec()
    assert (tm.spec.kind, tm.spec.shape, tm.spec.ranks) == (spec.kind, spec.shape, spec.ranks)
    _check(*_forward_and_grads(jm, tm, _rand(1, 2, 4, 12, 24)))


OPTIONS = {
    # (constructor kwargs, call kwargs)
    "scaled x2": (dict(resolution_scaling_factor=2), {}),
    "scaled 0.5 x 1": (dict(resolution_scaling_factor=(0.5, 1)), {}),
    "grid pair, output_shape": (dict(sht_grids=("equiangular", "legendre-gauss")),
                                dict(output_shape=(16, 20))),
    "legendre-gauss": (dict(sht_grids="legendre-gauss"), {}),
    "per-call n_modes": ({}, dict(n_modes=(6, 8))),
    "no bias, init_std": (dict(use_bias=False, init_std=0.3), {}),
}


@pytest.mark.parametrize("option", OPTIONS)
def test_spherical_conv_options_match_jax(option):
    kwargs, call = OPTIONS[option]
    jm = JSphericalConv(4, 4, (8, 12), factorization="dense", **kwargs)
    tm = SphericalConv(4, 4, (8, 12), factorization="dense", device="cpu", **kwargs)
    _check(*_forward_and_grads(jm, tm, _rand(2, 2, 4, 12, 24), call=call, init_call={}))
    assert ("bias" in dict(tm.named_parameters())) == kwargs.get("use_bias", True)


@pytest.mark.parametrize("kwargs,output_shape", [
    (dict(resolution_scaling_factor=2), None),
    (dict(sht_grids=("equiangular", "legendre-gauss")), None),
    ({}, (10, 20)),
])
def test_spherical_conv_transform_matches_jax(kwargs, output_shape):
    """The skip branches' resampling through the SHT; the identity when
    neither size nor grid changes."""
    x = _rand(3, 2, 4, 12, 24)
    jm = JSphericalConv(4, 4, (8, 12), factorization="dense", **kwargs)
    tm = SphericalConv(4, 4, (8, 12), factorization="dense", device="cpu", **kwargs)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    expected = np.asarray(jm.apply({"params": params}, jnp.asarray(x), output_shape,
                                   method=JSphericalConv.transform))
    got = tm.transform(torch.from_numpy(x), output_shape).numpy()
    assert got.shape == expected.shape and _rel_l2(got, expected) <= F32_TOL
    same = SphericalConv(4, 4, (8, 12), device="cpu")
    xt = torch.from_numpy(x)
    assert same.transform(xt) is xt


def test_fno_blocks_take_spherical_conv_as_jax_does():
    """``FNOBlocks`` builds any ``conv_module``; ``weight_dtype`` and
    ``enforce_hermitian_symmetry`` reach ``SpectralConv`` subclasses only,
    so a ``SphericalConv`` stays f32 under ``weight_dtype="bfloat16"``."""
    kwargs = dict(n_layers=2, conv_module=SphericalConv, factorization="dense",
                  weight_dtype="bfloat16", enforce_hermitian_symmetry=False)
    blocks = FNOBlocks(4, 4, (8, 12), device="cpu", **kwargs)
    assert isinstance(blocks.conv_1, SphericalConv)
    assert blocks.conv_0.w_weight.dtype == torch.float32

    class Spectral(SpectralConv):
        pass

    spectral = FNOBlocks(4, 4, (4, 4), conv_module=Spectral, weight_dtype="bfloat16",
                         enforce_hermitian_symmetry=False, device="cpu")
    assert spectral.conv_0.w_weight.dtype == torch.bfloat16
    assert not spectral.conv_0.enforce_hermitian_symmetry

    jblocks = JFNOBlocks(4, 4, (8, 12), **{**kwargs, "conv_module": JSphericalConv})
    x = _rand(4, 2, 4, 12, 24)
    params = jblocks.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          method=lambda m, x: [m(x, i) for i in range(2)])["params"]
    convert.check_flax_params(params, blocks.state_dict())
    _load(blocks, params)
    for index in range(2):
        expected = np.asarray(jblocks.apply({"params": params}, jnp.asarray(x), index))
        got = blocks(torch.from_numpy(x), index).detach().numpy()
        assert _rel_l2(got, expected) <= F32_TOL


def test_small_sfno_forward_and_gradients_match_jax():
    kwargs = dict(n_modes=(8, 12), in_channels=3, out_channels=3, hidden_channels=8,
                  n_layers=2, domain_padding=0.05)
    _check(*_forward_and_grads(JSFNO(**kwargs), SFNO(**kwargs, device="cpu"),
                               _rand(5, 2, 3, 12, 24)))


def test_recorded_sfno_has_the_jax_parameters_and_forward():
    jm = JSFNO(**RECORDED)
    x = _rand(6, 2, 3, 32, 64)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = SFNO(**RECORDED, device="cpu")
    convert.check_flax_params(params, tm.state_dict())
    assert sum(p.numel() for p in tm.parameters()) == RECORDED_PARAMS
    assert tm.fno_blocks.conv_0.w_weight.shape == (2, 64, 64, 16)
    _load(tm, params)
    apply = jax.jit(jm.apply)
    for shape in ((32, 64), (64, 128)):
        x = _rand(7, 2, 3, *shape)
        expected = np.asarray(apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 3, *shape) and _rel_l2(got, expected) <= F32_TOL


def test_get_model_builds_the_sfno_preset_with_jax_names():
    jmodel = jget_model({"model": JSFNO_Small2d().to_dict()})
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, 3, 16, 32))),
                            jax.random.PRNGKey(0))["params"]
    model = get_model({"model": SFNO_Small2d().to_dict()}, device="meta")
    assert type(model) is SFNO
    assert isinstance(model.fno_blocks.conv_3, SphericalConv)
    convert.check_flax_params(shapes, model.state_dict())


def test_sfno_metadata_round_trip(tmp_path):
    model = SFNO(n_modes=(4, 8), in_channels=3, out_channels=3, hidden_channels=4, n_layers=1,
                 device="cpu")
    path = save_arch_metadata(model, tmp_path, "sfno")
    assert '"__class__": "SphericalConv"' in path.read_text()
    rebuilt = model_from_metadata(path, device="meta")
    assert type(rebuilt) is SFNO and isinstance(rebuilt.fno_blocks.conv_0, SphericalConv)
    assert {k: v.shape for k, v in rebuilt.state_dict().items()} == \
        {k: v.shape for k, v in model.state_dict().items()}


def test_swe_generator_matches_jax():
    kwargs = dict(n_train=5, n_test=3, batch_size=2, test_batch_sizes=(2, 2),
                  train_resolution=(16, 32), test_resolutions=((16, 32), (32, 64)), seed=3)
    jtrain, jtests, jproc = jswe.load_spherical_swe(**kwargs)
    ttrain, ttests, tproc = tswe.load_spherical_swe(**kwargs)
    assert jproc is None and tproc is None and list(ttests) == list(jtests) == [(16, 32), (32, 64)]
    for j, t in [(jtrain, ttrain)] + [(jtests[k], ttests[k]) for k in jtests]:
        assert t.batch_size == j.batch_size and t.shuffle == j.shuffle
        for key in ("x", "y"):
            a, b = t.dataset.arrays[key], j.dataset.arrays[key]
            assert a.dtype == np.float32 and a.shape == b.shape
            assert _rel_l2(a, b) <= DATA_TOL, key
    # the shuffled loader visits the pairs in the JAX loader's order
    order = [np.asarray(batch["x"]) for batch in jtrain]
    for got, expected in zip(ttrain, order):
        assert _rel_l2(got["x"], expected) <= DATA_TOL


def test_swe_dataset_items_match_jax():
    jds = jswe.SphericalSWEDataset(dt=3600, dims=(16, 32), num_examples=4, seed=1)
    tds = tswe.SphericalSWEDataset(dt=3600, dims=(16, 32), num_examples=4, seed=1)
    assert tds.nsteps == jds.nsteps and len(tds) == 4
    for i in range(4):
        a, b = tds[i], jds[i]
        for key in ("x", "y"):
            assert a[key].dtype == np.float32 and _rel_l2(a[key], b[key]) <= DATA_TOL
    with pytest.raises(ValueError, match="random"):
        tswe.SphericalSWEDataset(initial_condition="galewsky")


def test_cosine_annealing_matches_optax():
    base, epochs, steps = 5e-3, 7, 3
    T = epochs * steps
    expected = optax.cosine_decay_schedule(base, T)
    schedule = cosine_annealing(base, epochs, steps)
    for count in (0, 1, T // 2, T - 1, T, T + 5):
        ref = np.float32(expected(jnp.asarray(count, jnp.int32)))
        got = schedule(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.item() == ref, count
        value = schedule(count)
        assert isinstance(value, float)
        assert abs(value - float(ref)) <= 2 * np.finfo(np.float32).eps * base, count
    assert schedule(T) == 0.0 and schedule(T + 5) == 0.0
    with pytest.raises(ValueError, match="positive"):
        cosine_annealing(base, 0, steps)
