"""The modules no model builds, in the PyTorch port against the JAX package,
on the CPU: the legacy spectral convolutions, the divergence-free spectral
projection, the attention kernel integral, the half-precision complex
einsums, and the CODA layer over spherical convolutions.

Each module is built in both packages and the port's holds JAX's
parameters (``convert.convert_flax_params``: the flax paths are the port's
names). Bounds, relative to the largest entry of JAX's answer: forwards in
f32 within 1e-5 (the FFTs and einsums round in other orders; read 2e-7 to
4e-7); parameter gradients of the legacy convolutions within 1e-4 per leaf;
the projection within 1e-5, its output's spectral divergence below 1e-6 of
the largest wavenumber times the largest mode in both packages; ``einsum_complexhalf`` (bf16
parts, f32 products) within 1e-5 of JAX's, and 1e-2 from the exact product
of the unrounded operands; the CODA layer's forward within 1e-5 relative
l2 and its gradients within 1e-4 per leaf (against the larger of the
leaf's norm and 1% of the whole gradient's, as ``tests/test_torch_coda_layer.py``),
but for a leaf whose JAX gradient is below 1e-6 of the whole (a bias that
a norm follows, whose exact gradient is 0): the port's within 1e-5 of the
whole there (read 1.6e-6, JAX's 4.8e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.layers import attention_kernel_integral as jattn
from neuraloperator_tpu.layers import coda_layer as jcoda
from neuraloperator_tpu.layers import einsum_utils as jeinsum
from neuraloperator_tpu.layers import legacy_spectral_convolution as jlegacy
from neuraloperator_tpu.layers.embeddings import RotaryEmbedding2D as JRotary
from neuraloperator_tpu.layers.spherical_convolution import SphericalConv as JSphericalConv
from neuraloperator_tpu.layers.spectral_projection import (
    spectral_projection_divergence_free as jproject,
)
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.layers import attention_kernel_integral as tattn
from neuraloperator_tpu_torch.layers import einsum_utils as teinsum
from neuraloperator_tpu_torch.layers import legacy_spectral_convolution as tlegacy
from neuraloperator_tpu_torch.layers import spectral_projection as tproj
from neuraloperator_tpu_torch.layers.base_spectral_conv import BaseSpectralConv
from neuraloperator_tpu_torch.layers.coda_layer import CODALayer
from neuraloperator_tpu_torch.layers.embeddings import RotaryEmbedding2D
from neuraloperator_tpu_torch.layers.spherical_convolution import SphericalConv

torch.set_num_threads(1)

TOL, GRAD_TOL = 1e-5, 1e-4


def max_rel(got, want) -> float:
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


def both(jm, tm, args, kwargs=None, targs=None, tkwargs=None):
    """JAX's module initialized on ``args`` and the port's holding its
    parameters; returns (params, JAX output, port output)."""
    kwargs = kwargs or {}
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, **kwargs))(*jargs)["params"]
    tm.load_state_dict(convert.convert_flax_params(params, tm.state_dict(), device="cpu"))
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kwargs))(params, *jargs)
    got = tm(*(targs or [torch.from_numpy(a) for a in args]), **(tkwargs or kwargs))
    return params, want, got


LEGACY = {
    "1d": (lambda: jlegacy.SpectralConv1d(3, 4, 5),
           lambda: tlegacy.SpectralConv1d(3, 4, 5, device="cpu"), (2, 3, 16), {}),
    "2d": (lambda: jlegacy.SpectralConv2d(3, 4, (4, 4)),
           lambda: tlegacy.SpectralConv2d(3, 4, (4, 4), device="cpu"), (2, 3, 12, 10), {}),
    "3d": (lambda: jlegacy.SpectralConv3d(3, 4, (2, 3, 3)),
           lambda: tlegacy.SpectralConv3d(3, 4, (2, 3, 3), device="cpu"), (2, 3, 8, 8, 6), {}),
}
for _f in ("tucker", "cp", "tt", None):
    LEGACY[f"joint-2d-{_f}"] = (
        lambda f=_f: jlegacy.JointFactorizedSpectralConv(3, 3, (6, 6), n_layers=3,
                                                         factorization=f),
        lambda f=_f: tlegacy.JointFactorizedSpectralConv(3, 3, (6, 6), n_layers=3,
                                                         factorization=f, device="cpu"),
        (2, 3, 12, 10), {"layer_index": 2})
    LEGACY[f"joint-1d-{_f}"] = (
        lambda f=_f: jlegacy.JointFactorizedSpectralConv(3, 3, (6,), n_layers=2,
                                                         factorization=f, use_bias=False),
        lambda f=_f: tlegacy.JointFactorizedSpectralConv(3, 3, (6,), n_layers=2,
                                                         factorization=f, use_bias=False,
                                                         device="cpu"),
        (2, 3, 16), {"layer_index": 1})


@pytest.mark.parametrize("case", sorted(LEGACY))
def test_legacy_spectral_convs_match_jax(case):
    make_j, make_t, shape, kwargs = LEGACY[case]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm, tm = make_j(), make_t()
    params, want, got = both(jm, tm, [x], kwargs)
    assert got.shape == want.shape == shape[:1] + (want.shape[1],) + shape[2:]
    assert max_rel(got.detach().numpy(), want) < TOL
    # gradients of a fixed weighted sum of the outputs
    wsum = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, jnp.asarray(x), **kwargs) * wsum)))(params)
    (got * torch.from_numpy(wsum)).sum().backward()
    flat = convert.flatten_flax(jgrads)
    for name, p in tm.named_parameters():
        w = np.asarray(flat[name], np.float64)
        assert np.linalg.norm(p.grad.numpy() - w) / np.linalg.norm(w) < GRAD_TOL, name


def test_sub_conv_is_one_layer_of_the_joint_conv():
    conv = tlegacy.JointFactorizedSpectralConv(3, 3, (6, 6), n_layers=3, device="cpu",
                                               generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 12, 10, generator=torch.Generator().manual_seed(1))
    for i in range(3):
        torch.testing.assert_close(tlegacy.SubConv(conv, i)(x), conv(x, layer_index=i),
                                   rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="1-D and 2-D"):
        tlegacy.JointFactorizedSpectralConv(2, 2, (4, 4, 4), device="cpu")(
            torch.zeros(1, 2, 8, 8, 8))


def divergence(u: np.ndarray) -> float:
    """Largest spectral divergence |kx û0 + ky û1| of (b, 2, h, w) fields,
    relative to the largest wavenumber times the largest mode."""
    h, w = u.shape[-2:]
    uh = np.fft.rfftn(u, axes=(-2, -1), norm="forward")
    kx = np.fft.fftfreq(h, d=1.0 / h)[:, None]
    ky = np.fft.rfftfreq(w, d=1.0 / w)[None, :]
    k_max = np.sqrt(kx ** 2 + ky ** 2).max()
    return float(np.abs(kx * uh[:, 0] + ky * uh[:, 1]).max() / (k_max * np.abs(uh).max()))


@pytest.mark.parametrize("shape", [(2, 2, 16, 12), (1, 2, 15, 17)])
def test_spectral_projection_matches_jax_and_is_divergence_free(shape):
    u = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jproject(jnp.asarray(u)))
    got = tproj.spectral_projection_divergence_free(torch.from_numpy(u)).numpy()
    assert got.shape == u.shape and got.dtype == np.float32
    assert max_rel(got, want) < TOL
    assert divergence(u) > 0.01
    assert divergence(got) < 1e-6 and divergence(want) < 1e-6
    with pytest.raises(ValueError, match="2-component"):
        tproj.spectral_projection_divergence_free(torch.zeros(1, 3, 8, 8))


ATTENTION = [(2, 8, 8), (3, 4, 5), (1, 8, 16), (2, 4, 8)]


@pytest.mark.parametrize("heads,head_ch,out", ATTENTION)
@pytest.mark.parametrize("mode", ["self", "rotary", "cross", "weights", "kernel"])
def test_attention_kernel_integral_matches_jax(heads, head_ch, out, mode):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 20, 8)).astype(np.float32)
    pos = rng.random((2, 20, 2)).astype(np.float32)
    jm = jattn.AttentionKernelIntegral(8, out, heads, head_ch)
    tm = tattn.AttentionKernelIntegral(8, out, heads, head_ch, device="cpu")
    jkw, tkw = {}, {}
    if mode in ("rotary", "cross"):
        jkw["positional_embedding_module"] = JRotary(head_ch // 2)
        tkw["positional_embedding_module"] = RotaryEmbedding2D(head_ch // 2)
    if mode == "cross":
        uq, pq = rng.standard_normal((2, 7, 8)).astype(np.float32), rng.random((2, 7, 2))
        pq = pq.astype(np.float32)
        jkw.update(u_qry=jnp.asarray(uq), pos_qry=jnp.asarray(pq))
        tkw.update(u_qry=torch.from_numpy(uq), pos_qry=torch.from_numpy(pq))
    if mode == "weights":
        wq = rng.random((2, 20)).astype(np.float32)
        jkw["weights"], tkw["weights"] = jnp.asarray(wq), torch.from_numpy(wq)
    if mode == "kernel":
        jkw = tkw = {"associative": False, "return_kernel": True}
    _, want, got = both(jm, tm, [u, pos], jkw, tkwargs=tkw)
    if mode == "kernel":
        (want, jk), (got, tk) = want, got
        assert max_rel(tk.detach().numpy(), jk) < TOL
    assert got.shape == want.shape
    assert max_rel(got.detach().numpy(), want) < TOL
    assert (tm.to_out is None) == (heads * head_ch == out)


def test_attention_kernel_integral_refuses_what_jax_refuses():
    tm = tattn.AttentionKernelIntegral(4, 4, 1, 4, device="cpu")
    u, pos = torch.zeros(1, 5, 4), torch.zeros(1, 5, 2)
    with pytest.raises(ValueError, match="without a query function"):
        tm(u, pos, pos_qry=pos)
    with pytest.raises(ValueError, match="without query coordinates"):
        tm(u, pos, u_qry=u)
    with pytest.raises(ValueError, match="associative=True"):
        tm(u, pos, return_kernel=True)


def test_attention_init_is_xavier_plus_a_scaled_identity():
    tm = tattn.AttentionKernelIntegral(16, 32, 2, 16, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    gain, limit = 0.25, 0.25 * (6.0 / 32) ** 0.5
    for w in (tm.wq, tm.wk, tm.wv):
        assert w.shape == (16, 32)
        for h in range(2):
            block = w[:, 16 * h:16 * (h + 1)].detach() - gain * torch.eye(16)
            assert float(block.abs().max()) <= limit
            assert float(block.std()) > 0.5 * limit / 3 ** 0.5


@pytest.mark.parametrize("eq,shapes", [("bix,iox->box", ((2, 3, 5), (3, 4, 5))),
                                       ("ij,jk->ik", ((4, 6), (6, 3)))])
def test_einsum_complexhalf_matches_jax(eq, shapes):
    rng = np.random.default_rng(4)
    a, b = ((rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)
            for s in shapes)
    want = np.asarray(jeinsum.einsum_complexhalf(eq, jnp.asarray(a), jnp.asarray(b)))
    for fn in (teinsum.einsum_complexhalf, teinsum.einsum_complexhalf_two_input):
        re, im = fn(eq, torch.from_numpy(a), torch.from_numpy(b))
        got = re.numpy() + 1j * im.numpy()
        assert max_rel(got, want) < TOL
        exact = np.einsum(eq, a.astype(np.complex128), b.astype(np.complex128))
        assert 1e-4 < max_rel(got, exact) < 1e-2


def test_base_spectral_conv_asks_for_transform():
    with pytest.raises(NotImplementedError, match="transform"):
        BaseSpectralConv().transform(torch.zeros(1))


@pytest.mark.parametrize("kwargs", [dict(per_channel_attention=True),
                                    dict(per_channel_attention=False, token_codimension=2,
                                         n_heads=2)], ids=["per_channel", "two_heads"])
def test_coda_layer_over_spherical_convolutions_matches_jax(kwargs):
    x = np.random.default_rng(6).standard_normal((2, 6, 8, 16)).astype(np.float32)
    jm = jcoda.CODALayer(n_modes=(4, 4), conv_module=JSphericalConv, **kwargs)
    tm = CODALayer((4, 4), conv_module=SphericalConv, device="cpu", **kwargs)
    params, want, got = both(jm, tm, [x])
    assert got.shape == want.shape
    want64 = np.asarray(want, np.float64)
    assert np.linalg.norm(got.detach().numpy() - want64) / np.linalg.norm(want64) < TOL
    r = np.random.default_rng(7).standard_normal(want.shape).astype(np.float32)
    jgrads = convert.flatten_flax(jax.jit(jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r)))(params))
    (got * torch.from_numpy(r)).sum().backward()
    total = sum(float(np.square(np.asarray(g, np.float64)).sum()) for g in jgrads.values()) ** 0.5
    for name, p in tm.named_parameters():
        ref = np.asarray(jgrads[name], np.float64)
        err = np.linalg.norm(p.grad.double().numpy() - ref)
        if np.linalg.norm(ref) < 1e-6 * total:
            # a bias that a norm follows: zero but for f32 rounding, in both
            assert err < 1e-5 * total, name
        else:
            assert err / max(np.linalg.norm(ref), 1e-2 * total) < GRAD_TOL, name
