"""The GNO layers of the PyTorch port against the JAX package, on the CPU.

``LinearChannelMLP``, the sinusoidal and rotary embeddings, the mollifier
weighting functions, the segment reductions, the neighbour searches (the
port's C++ grid hash, its numpy plain version, the padded search), the
integral transform and ``GNOBlock``: the same numpy inputs and the JAX
layers' parameters, converted, through both packages.

Bounds: forwards within 1e-5 relative l2 (f32 sums in another order) and
parameter gradients within 1e-4; the C++ and numpy searches equal to the
index; the padded search compared as sets, which may differ only at near
ties (``tie_gap`` below), the cases counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu import native as jnative
from neuraloperator_tpu.layers import channel_mlp as jcm
from neuraloperator_tpu.layers import embeddings as jemb
from neuraloperator_tpu.layers import gno_block as jgb
from neuraloperator_tpu.layers import gno_weighting_functions as jw
from neuraloperator_tpu.layers import integral_transform as jit_
from neuraloperator_tpu.layers import neighbor_search as jns
from neuraloperator_tpu.layers import segment_csr as jseg
from neuraloperator_tpu_torch import _native, convert
from neuraloperator_tpu_torch.layers import channel_mlp as tcm
from neuraloperator_tpu_torch.layers import embeddings as temb
from neuraloperator_tpu_torch.layers import gno_block as tgb
from neuraloperator_tpu_torch.layers import gno_weighting_functions as tw
from neuraloperator_tpu_torch.layers import integral_transform as tit
from neuraloperator_tpu_torch.layers import neighbor_search as tns
from neuraloperator_tpu_torch.layers import segment_csr as tseg

torch.set_num_threads(1)

TOL, GRAD_TOL = 1e-5, 1e-4
# a query's kept set may differ between the packages only by points whose
# float64 squared distance lies within this of its cut (the k-th squared
# distance, or the radius squared): the f32 expanded form rounds by some
# 2e-7 on the unit cube
TIE_MARGIN = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def load(module, params):
    module.load_state_dict(convert.convert_flax_params(params, module.state_dict(),
                                                       device="cpu"))
    return module


def tie_gap(found, ref, data, queries, radius) -> tuple:
    """(queries whose kept sets differ, the largest gap of a differing point
    from its query's cut) between two padded neighbour lists."""
    data, queries = np.asarray(data, np.float64), np.asarray(queries, np.float64)
    exact = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    m, n = exact.shape

    def members(nb):
        idx, mask = np.asarray(nb["neighbors_index"]), np.asarray(nb["neighbors_mask"])
        out = np.zeros((m, n), bool)
        rows = np.broadcast_to(np.arange(m)[:, None], idx.shape)
        out[rows[mask], idx[mask]] = True
        return out

    diff = members(found) ^ members(ref)
    k = np.asarray(ref["neighbors_index"]).shape[1]
    kth = np.sort(np.where(exact <= radius ** 2, exact, np.inf), axis=1)[:, k - 1]
    cut = np.where(np.isfinite(kth), kth, radius ** 2)
    gap = np.minimum(np.abs(exact - cut[:, None]), np.abs(exact - radius ** 2))
    return int(diff.any(axis=1).sum()), float(np.where(diff, gap, 0.0).max(initial=0.0))


@pytest.fixture(scope="module")
def cloud():
    """A body's vertices scaled into the unit cube (256) and an 8³ grid."""
    from neuraloperator_tpu_torch.data.datasets.synthetic_cfd import generate_cfd_sample

    verts = generate_cfd_sample(np.random.default_rng(3), n_verts=256, grid_n=8)["vertices"]
    verts = (verts - verts.min(0)) / (verts.max(0) - verts.min(0))
    axes = [np.linspace(0, 1, 8)] * 3
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return verts.astype(np.float32), grid.astype(np.float32)


def test_linear_channel_mlp_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 6)).astype(np.float32)
    jmod = jcm.LinearChannelMLP(layers=[6, 16, 16, 4])
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tmod = tcm.LinearChannelMLP([6, 16, 16, 4], device="cpu")
    assert sorted(tmod.state_dict()) == ["fc0.bias", "fc0.kernel", "fc1.bias", "fc1.kernel",
                                         "fc2.bias", "fc2.kernel"]
    load(tmod, params)
    assert rel(tmod(t(x)).detach(), jmod.apply({"params": params}, jnp.asarray(x))) < TOL
    with pytest.raises(ValueError):
        tcm.LinearChannelMLP([4], device="cpu")


@pytest.mark.parametrize("kind", ["transformer", "nerf"])
def test_sinusoidal_embedding_matches_jax(kind):
    x = np.random.default_rng(1).uniform(0, 1, (2, 7, 3)).astype(np.float32)
    jemb_ = jemb.SinusoidalEmbedding(3, num_frequencies=5, embedding_type=kind)
    temb_ = temb.SinusoidalEmbedding(3, num_frequencies=5, embedding_type=kind)
    assert temb_.out_channels == jemb_.out_channels == 30
    assert rel(temb_(t(x)), jemb_(jnp.asarray(x))) < TOL
    assert rel(temb_(t(x[0])), jemb_(jnp.asarray(x[0]))) < TOL
    assert temb_(t(x[0])).shape == (7, 30)


def test_sinusoidal_embedding_refuses_unknown_types():
    with pytest.raises(ValueError, match="transformer"):
        temb.SinusoidalEmbedding(2, 4, embedding_type="fourier")(torch.zeros(3, 2))


def test_rotary_embedding_matches_jax():
    rng = np.random.default_rng(2)
    coords = rng.uniform(0, 1, (4, 6)).astype(np.float32)
    feats = rng.standard_normal((4, 6, 8)).astype(np.float32)
    jr, tr = jemb.RotaryEmbedding2D(8), temb.RotaryEmbedding2D(8)
    jf, tf = jr(jnp.asarray(coords)), tr(t(coords))
    assert rel(tf, jf) < TOL
    assert rel(temb.apply_rotary_pos_emb(t(feats), tf),
               jemb.apply_rotary_pos_emb(jnp.asarray(feats), jf)) < TOL
    assert rel(tr.apply_2d_rotary_pos_emb(t(feats), tf[..., :4], tf[..., 4:]),
               jr.apply_2d_rotary_pos_emb(jnp.asarray(feats), jf[..., :4], jf[..., 4:])) < TOL


@pytest.mark.parametrize("name", ["bump", "half_cos", "quadr", "quartic", "octic"])
def test_weighting_functions_match_jax(name):
    sq = np.random.default_rng(4).uniform(-0.01, 0.2, 50).astype(np.float32)
    got = tw.dispatch_weighting_fn(name, sq_radius=0.09, scale=1.5)(t(sq))
    want = jw.dispatch_weighting_fn(name, sq_radius=0.09, scale=1.5)(jnp.asarray(sq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert getattr(tw, f"{name}_cutoff") is getattr(tw, name)
    with pytest.raises(ValueError, match="unknown weighting fn"):
        tw.dispatch_weighting_fn("gauss", 1.0)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_segment_reductions_match_jax(reduction):
    rng = np.random.default_rng(5)
    src = rng.standard_normal((2, 9, 3)).astype(np.float32)
    # an empty segment, and rows past the last split that belong to none
    indptr = np.array([0, 2, 2, 5, 7])
    for s in (src, src[0]):
        got = tseg.segment_csr(t(s), t(indptr), reduction)
        want = jseg.segment_csr(jnp.asarray(s), jnp.asarray(indptr), reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    values = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    mask = rng.uniform(size=(4, 5)) < 0.6
    mask[1] = False
    got = tseg.masked_segment_reduce(t(values), t(mask), reduction)
    want = jseg.masked_segment_reduce(jnp.asarray(values), jnp.asarray(mask), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_cpp_search_equals_the_jax_searches_to_the_index(dim):
    rng = np.random.default_rng(10 + dim)
    data = rng.uniform(0, 1, (300, dim)).astype(np.float32)
    queries = rng.uniform(-0.1, 1.1, (120, dim)).astype(np.float32)
    radius = {1: 0.02, 2: 0.1, 3: 0.2}[dim]
    index, splits = tns.fixed_radius_search_cpp(data, queries, radius)
    jindex, jsplits = jnative.fixed_radius_search_cpp(data, queries, radius)
    np.testing.assert_array_equal(index, jindex)
    np.testing.assert_array_equal(splits, jsplits)
    nindex, nsplits, norms = tns.fixed_radius_search_numpy(data, queries, radius)
    np.testing.assert_array_equal(index, nindex)
    np.testing.assert_array_equal(splits, nsplits)
    assert len(index) > 0
    # JAX's numpy search (its fallback without the C++ library)
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(index, np.nonzero(d2 <= radius ** 2)[1])
    got = tns.native_neighbor_search(data, queries, radius, return_norm=True)
    want = jns.native_neighbor_search(data, queries, radius, return_norm=True)
    for key in ("neighbors_index", "neighbors_row_splits"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    np.testing.assert_allclose(got["neighbors_norm"].numpy(), want["neighbors_norm"], rtol=1e-6)
    np.testing.assert_allclose(norms, want["neighbors_norm"], rtol=1e-6)


def test_search_above_three_dims_is_the_numpy_one():
    rng = np.random.default_rng(20)
    data, queries = rng.uniform(0, 1, (80, 4)), rng.uniform(0, 1, (10, 4))
    got = tns.native_neighbor_search(data, queries, 0.5, return_norm=True)
    want = jns.native_neighbor_search(data, queries, 0.5, return_norm=True)
    for key in ("neighbors_index", "neighbors_row_splits", "neighbors_norm"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    with pytest.raises(ValueError, match="1-3 dims"):
        tns.fixed_radius_search_cpp(data, queries, 0.5)


def test_a_failed_build_of_the_search_raises(tmp_path, monkeypatch):
    (tmp_path / "neighbor_search.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_native, "_builds", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.build_host_library("neighbor_search")
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("cap", [None, 3])
def test_csr_to_padded_matches_jax(cap):
    rng = np.random.default_rng(21)
    data = rng.uniform(0, 1, (60, 2)).astype(np.float32)
    queries = rng.uniform(0, 1, (15, 2)).astype(np.float32)
    csr = jns.native_neighbor_search(data, queries, 0.3, return_norm=True)
    got = tns.csr_to_padded({k: t(v) for k, v in csr.items()}, max_neighbors=cap)
    want = jns.csr_to_padded(csr, max_neighbors=cap)
    for key in ("neighbors_index", "neighbors_mask", "neighbors_norm"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("side", ["in", "out"])
def test_padded_search_matches_jax_as_sets(cloud, side):
    """GINO's two searches at a radius that keeps k = 8 of 20-70 candidates:
    the kept sets equal JAX's but at near ties, counted; where they agree the
    norms agree too."""
    verts, grid = cloud
    data, queries = (verts, grid) if side == "in" else (grid, verts)
    radius, k = 0.3, 8
    got = tns.padded_neighbor_search(t(data), t(queries), radius, k, return_norm=True)
    want = jns.padded_neighbor_search(jnp.asarray(data), jnp.asarray(queries), radius, k,
                                      return_norm=True)
    differing, gap = tie_gap(got, want, data, queries, radius)
    assert gap <= TIE_MARGIN and differing <= 2, (differing, gap)
    np.testing.assert_array_equal(got["neighbors_mask"].sum(1).numpy(),
                                  np.asarray(want["neighbors_mask"]).sum(1))
    assert np.asarray(want["neighbors_mask"]).all(axis=1).mean() > 0.5
    np.testing.assert_allclose(np.sort(got["neighbors_norm"].numpy(), 1),
                               np.sort(np.asarray(want["neighbors_norm"]), 1), atol=1e-6)


def test_padded_search_keeps_the_cross_term_in_full_f32(monkeypatch):
    entered = []

    class Recording:
        def __enter__(self):
            entered.append(True)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tns, "dft_matmul_precision", Recording)
    tns.padded_neighbor_search(torch.rand(10, 3), torch.rand(4, 3), 0.5, 3)
    assert entered == [True]


def test_neighbor_search_modes_match_jax(cloud):
    verts, grid = cloud
    for mode, cap in (("csr", None), ("padded", None), ("padded", 6)):
        got = tns.NeighborSearch(mode=mode, max_neighbors=cap, return_norm=True)(
            verts, grid[:100], 0.2)
        want = jns.NeighborSearch(mode=mode, max_neighbors=cap, return_norm=True)(
            verts, grid[:100], 0.2)
        if cap is not None:
            assert tie_gap(got, want, verts, grid[:100], 0.2)[1] <= TIE_MARGIN
            continue
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6)


def _transform_inputs(batched: bool):
    rng = np.random.default_rng(30)
    y = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (12, 2)).astype(np.float32)
    f_y = rng.standard_normal((2, 40, 3) if batched else (40, 3)).astype(np.float32)
    nb = {k: np.asarray(v) for k, v in
          jns.padded_neighbor_search(jnp.asarray(y), jnp.asarray(x), 0.35, 6,
                                     return_norm=True).items()}
    return y, x, f_y, nb


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("transform_type",
                         ["linear", "nonlinear", "linear_kernelonly", "nonlinear_kernelonly"])
def test_integral_transform_matches_jax(transform_type, batched):
    y, x, f_y, nb = _transform_inputs(batched)
    nb.pop("neighbors_norm")
    kernel_in = 4 + (3 if transform_type.startswith("nonlinear") else 0)
    layers = (kernel_in, 16, 3)
    jmod = jit_.IntegralTransform(channel_mlp_layers=layers, transform_type=transform_type,
                                  reduction="mean")
    args = (jnp.asarray(y), nb, jnp.asarray(x), jnp.asarray(f_y))
    params = jmod.init(jax.random.PRNGKey(1), *args)["params"]
    tmod = load(tit.IntegralTransform(layers, transform_type=transform_type, reduction="mean",
                                      device="cpu"), params)
    tnb = {k: t(v) for k, v in nb.items()}
    out = tmod(t(y), tnb, t(x), t(f_y))
    want = jmod.apply({"params": params}, *args)
    assert out.shape == want.shape
    assert rel(out.detach(), want) < TOL
    # parameter gradients of a weighted sum of the output
    w = np.random.default_rng(31).standard_normal(want.shape).astype(np.float32)
    (out * t(w)).sum().backward()
    jgrad = jax.grad(lambda p: (jmod.apply({"params": p}, *args) * w).sum())(params)
    flat = convert.flatten_flax(jgrad)
    for name, p in tmod.named_parameters():
        assert rel(p.grad, flat[name]) < GRAD_TOL, name


def test_integral_transform_with_weights_and_csr_matches_jax():
    y, x, f_y, nb = _transform_inputs(False)
    weight = jw.dispatch_weighting_fn("quartic", sq_radius=0.35 ** 2)
    jmod = jit_.IntegralTransform(channel_mlp_layers=(4, 8, 3), weighting_fn=weight)
    args = (jnp.asarray(y), nb, jnp.asarray(x), jnp.asarray(f_y))
    params = jmod.init(jax.random.PRNGKey(2), *args)["params"]
    tmod = load(tit.IntegralTransform((4, 8, 3), device="cpu",
                                      weighting_fn=tw.dispatch_weighting_fn(
                                          "quartic", sq_radius=0.35 ** 2)), params)
    out = tmod(t(y), {k: t(v) for k, v in nb.items()}, t(x), t(f_y))
    assert rel(out.detach(), jmod.apply({"params": params}, *args)) < TOL
    # the reference's CSR dict, padded inside the call
    csr = jns.native_neighbor_search(y, x, 0.35, return_norm=True)
    jout = jmod.apply({"params": params}, jnp.asarray(y), csr, jnp.asarray(x),
                      jnp.asarray(f_y))
    tout = tmod(t(y), tns.native_neighbor_search(y, x, 0.35, return_norm=True), t(x), t(f_y))
    assert rel(tout.detach(), jout) < TOL
    with pytest.raises(KeyError, match="norms"):
        tmod(t(y), {k: t(v) for k, v in nb.items() if k != "neighbors_norm"}, t(x), t(f_y))
    with pytest.raises(ValueError, match="transform_type"):
        tit.IntegralTransform((4, 3), transform_type="quadratic", device="cpu")


@pytest.mark.parametrize("embedding", ["transformer", "nerf", None])
def test_gno_block_matches_jax(embedding):
    rng = np.random.default_rng(40)
    y = rng.uniform(0, 1, (48, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    f_y = rng.standard_normal((1, 48, 4)).astype(np.float32)
    kw = dict(in_channels=4, out_channels=4, coord_dim=3, radius=0.4, max_neighbors=8,
              transform_type="nonlinear", pos_embedding_type=embedding,
              pos_embedding_channels=3, channel_mlp_layers=(16, 16))
    jmod = jgb.GNOBlock(**kw)
    args = (jnp.asarray(y), jnp.asarray(x), jnp.asarray(f_y))
    params = jmod.init(jax.random.PRNGKey(3), *args)["params"]
    tmod = load(tgb.GNOBlock(**kw, device="cpu"), params)
    want = np.asarray(jmod.apply({"params": params}, *args))
    nb = {k: t(np.asarray(v)) for k, v in
          jns.padded_neighbor_search(jnp.asarray(y), jnp.asarray(x), 0.4, 8).items()}
    assert rel(tmod(t(y), t(x), t(f_y), neighbors=nb).detach(), want) < TOL
    # searching inside the call: the same unless a near tie swaps a neighbour
    found = tns.padded_neighbor_search(t(y), t(x), 0.4, 8)
    if tie_gap(found, nb, y, x, 0.4)[0] == 0:
        assert rel(tmod(t(y), t(x), t(f_y)).detach(), want) < TOL
