"""The port's differentiation, Fourier continuation, equation, meta and the
remaining data losses against the JAX package's.

Both packages get the same seeded numpy fields. Bounds, f32 (each set by
a CPU probe of these cases, the largest reading in brackets):
- finite differences and central differences: the same stencils, within
  1e-5 of the largest entry [equal to the bit];
- spectral derivatives: pocketfft (JAX) against torch's FFT, both f32,
  within 2e-5 of the largest entry; with continuation, of the largest
  derivative on the continued domain, where the f32 FFT rounds (the
  continuation multiplies the corners by up to 475 per axis: in 3-D with
  FC-Gram JAX's own f32 answer lies 25% from its float64 one on the
  original grid) [1.6e-6 / 5.5e-6]; gradients within 2e-5 [8.1e-7], and
  1e-4 through the continuation [2.3e-5];
- the continuation's extend and restrict: the same float64 matrices (equal
  to the bit) cast to f32, then a matmul, ``rtol=1e-5``, ``atol=1e-6``
  [equal to the bit];
- point-cloud stencils: the same least squares, in float64 within 1e-9
  of JAX's with x64 [2.3e-11]; in f32 through pinv within 1e-4 of the
  largest derivative [1.9e-6], and through the ridge's normal equations,
  ill-conditioned in f32, no farther from JAX's float64 answer than twice
  JAX's own f32 answer (JAX's lies 2.5-4.6% from it, the port's 1.8-2.5%);
- losses: values ``rtol=1e-5`` and gradients ``rtol=1e-4`` with
  ``atol=1e-7`` times the largest gradient entry, as
  ``tests/test_torch_losses.py`` holds LpLoss and H1Loss;
- SoftAdapt and ReLoBRaLo keep float64 numpy histories in both packages:
  from the same loss values the weights are equal to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.layers import fourier_continuation as jfc
from neuraloperator_tpu.losses import data_losses as jdl
from neuraloperator_tpu.losses import differentiation as jd
from neuraloperator_tpu.losses import equation_losses as jeq
from neuraloperator_tpu.losses import meta_losses as jmeta
from neuraloperator_tpu_torch import losses as tlosses
from neuraloperator_tpu_torch.layers import fourier_continuation as tfc
from neuraloperator_tpu_torch.losses import differentiation as td

torch.set_num_threads(1)

FD_TOL = 1e-5
SPECTRAL_TOL, SPECTRAL_FC_GRAD_TOL = 2e-5, 1e-4
POINT_CLOUD_TOL, POINT_CLOUD_F64_TOL = 1e-4, 1e-9
SHAPES = {1: (2, 3, 24), 2: (2, 3, 20, 18), 3: (2, 1, 12, 10, 14)}


def _smooth(seed, shape, periodic=True):
    """A smooth field on the trailing dims (sums of a few sines), plus, when
    not ``periodic``, a linear ramp that breaks the periodicity."""
    rng = np.random.default_rng(seed)
    out = np.zeros(shape)
    n_spatial = {3: 1, 4: 2, 5: 3}[len(shape)]
    grids = np.meshgrid(*[np.linspace(0, 2 * np.pi, n, endpoint=False)
                          for n in shape[-n_spatial:]], indexing="ij")
    for _ in range(3):
        k = rng.integers(1, 4, size=n_spatial)
        amp = rng.standard_normal(shape[:-n_spatial] + (1,) * n_spatial)
        out = out + amp * np.sin(sum(kk * g for kk, g in zip(k, grids)) + rng.uniform(0, 6))
    if not periodic:
        out = out + 0.3 * sum(g for g in grids)
    return out.astype(np.float32)


def _close(got, want, tol, scale=None):
    """max |got - want| within ``tol`` of ``scale`` (the largest |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max() if scale is None else scale, 1e-12)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- FiniteDiff


@pytest.mark.parametrize("d,method", [(d, m) for d in (1, 2, 3)
                                      for m in ("laplacian", "gradient", "divergence", "curl")
                                      if not (m == "curl" and d == 1)])
@pytest.mark.parametrize("periodic", [True, False])
def test_finite_diff_operators(d, method, periodic):
    h = [0.1, 0.25, 0.5][:d]
    kwargs = dict(periodic_in_x=periodic, periodic_in_y=not periodic, periodic_in_z=periodic)
    port, ref = td.FiniteDiff(d, h, **kwargs), jd.FiniteDiff(d, h, **kwargs)
    u = _smooth(d, SHAPES[d], periodic)
    if method in ("divergence", "curl"):
        u = np.stack([_smooth(10 * d + i, SHAPES[d], periodic)[:, 0] for i in range(d)], axis=1)
    got = getattr(port, method)(_t(u)).numpy()
    want = np.asarray(getattr(ref, method)(jnp.asarray(u)))
    _close(got, want, FD_TOL)


def test_finite_diff_curl_refuses_1d():
    with pytest.raises(ValueError):
        td.FiniteDiff(1).curl(torch.zeros(2, 1, 8))


@pytest.mark.parametrize("fix", [False, True])
def test_central_differences(fix):
    u1, u2, u3 = (_smooth(i, SHAPES[i], periodic=False) for i in (1, 2, 3))
    _close(td.central_diff_1d(_t(u1), 0.1, fix_x_bnd=fix).numpy(),
           jd.central_diff_1d(jnp.asarray(u1), 0.1, fix_x_bnd=fix), FD_TOL)
    for got, want in zip(td.central_diff_2d(_t(u2), (0.1, 0.2), fix_x_bnd=fix, fix_y_bnd=not fix),
                         jd.central_diff_2d(jnp.asarray(u2), (0.1, 0.2), fix_x_bnd=fix,
                                            fix_y_bnd=not fix)):
        _close(got.numpy(), want, FD_TOL)
    for got, want in zip(td.central_diff_3d(_t(u3), 0.25, fix, not fix, fix),
                         jd.central_diff_3d(jnp.asarray(u3), 0.25, fix, not fix, fix)):
        _close(got.numpy(), want, FD_TOL)


# ------------------------------------------------------- Fourier continuation


@pytest.mark.parametrize("cls", ["FCLegendre", "FCGram"])
@pytest.mark.parametrize("n_add", [20, 13])
def test_fourier_continuation_extend_and_restrict(cls, n_add):
    port, ref = getattr(tfc, cls)(d=4, n_additional_pts=n_add), getattr(jfc, cls)(
        d=4, n_additional_pts=n_add)
    assert port.n_additional_pts == ref.n_additional_pts
    np.testing.assert_array_equal(port.ext_mat, ref.ext_mat)
    u = _smooth(5, SHAPES[2], periodic=False)
    for dim in (1, 2, [-2]):
        got = port.extend(_t(u), dim=dim)
        want = ref.extend(jnp.asarray(u), dim=dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        # an odd count leaves FCLegendre's restrict a point longer, in both
        back, jback = port.restrict(got, dim=dim).numpy(), np.asarray(ref.restrict(want, dim=dim))
        assert back.shape == jback.shape
        if n_add % 2 == 0 or cls == "FCGram":
            assert back.shape == u.shape
        np.testing.assert_allclose(back, jback, rtol=1e-5, atol=1e-6)
    assert port(_t(u), 1).shape == tuple(ref(jnp.asarray(u), 1).shape)


# ---------------------------------------------------------------- FourierDiff


FOURIER_CASES = {
    "plain": {},
    "low_pass": {"low_pass_filter_ratio": 0.5},
    "legendre": {"use_fc": "Legendre", "fc_degree": 4, "fc_n_additional_pts": 20},
    "gram": {"use_fc": "gram", "fc_degree": 4, "fc_n_additional_pts": 21},
}


def _extended_scale(ref, u, orders):
    """The largest derivative of the continued field on its whole domain,
    over ``orders``: the scale of the f32 FFT's rounding with continuation."""
    d = ref.dim
    n_add = ref.FC.n_additional_pts
    length = [lo * (n + n_add) / n for lo, n in zip(ref.L, u.shape[-d:])]
    ext = ref.FC.extend(jnp.asarray(u), dim=d)
    full = jd.FourierDiff(d, L=length)
    return max(float(jnp.abs(full.derivative(ext, o)).max()) for o in orders)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(FOURIER_CASES))
def test_fourier_diff(d, case):
    kwargs = FOURIER_CASES[case]
    periodic = "use_fc" not in kwargs
    L = [2 * np.pi, 3.0, 1.5][:d]
    port, ref = td.FourierDiff(d, L=L, **kwargs), jd.FourierDiff(d, L=L, **kwargs)
    u = _smooth(7 * d, SHAPES[d], periodic)
    tu, ju = _t(u), jnp.asarray(u)
    unit = [tuple(order if j == i else 0 for j in range(d)) for order in (1, 2) for i in range(d)]

    def close(got, want, field, orders):
        scale = None if periodic else _extended_scale(ref, field, orders)
        _close(got.numpy(), want, SPECTRAL_TOL, scale)

    for name, o in zip(("dx", "dy", "dz")[:d] * 2, unit):
        close(getattr(port, name)(tu, sum(o)), getattr(ref, name)(ju, sum(o)), u, [o])
    close(port.partial(tu, "x", 1), ref.partial(ju, "x", 1), u, unit[:1])
    orders = [(1,) * d, (2,) + (0,) * (d - 1)]
    for got, want, o in zip(port.compute_multiple_derivatives(tu, orders),
                            ref.compute_multiple_derivatives(ju, orders), orders):
        close(got, want, u, [o])
    close(port.laplacian(tu), ref.laplacian(ju), u, unit[d:])
    close(port.gradient(tu), ref.gradient(ju), u, unit[:d])
    if d > 1:
        v = np.stack([_smooth(30 + i, SHAPES[d], periodic)[:, 0] for i in range(d)], axis=1)
        close(port.divergence(_t(v)), ref.divergence(jnp.asarray(v)), v, unit[:d])
        close(port.curl(_t(v)), ref.curl(jnp.asarray(v)), v, unit[:d])


@pytest.mark.parametrize("use_fc,tol", [(False, SPECTRAL_TOL), ("legendre", SPECTRAL_FC_GRAD_TOL)])
def test_fourier_diff_gradients(use_fc, tol):
    u = _smooth(3, SHAPES[2], periodic=not use_fc)
    port = td.FourierDiff(2, L=(1.0, 2.0), use_fc=use_fc, fc_n_additional_pts=16)
    ref = jd.FourierDiff(2, L=(1.0, 2.0), use_fc=use_fc, fc_n_additional_pts=16)
    tu = _t(u).requires_grad_()
    (grad,) = torch.autograd.grad((port.dx(tu) ** 2).sum(), tu)
    want = jax.grad(lambda a: jnp.sum(ref.dx(a) ** 2))(jnp.asarray(u))
    _close(grad.numpy(), want, tol)


def test_fourier_diff_refusals():
    with pytest.raises(ValueError):
        td.FourierDiff(2, use_fc="chebyshev")
    with pytest.raises(ValueError):
        td.FourierDiff(2, L=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError):
        td.FourierDiff(1).curl(torch.zeros(2, 1, 8))
    with pytest.raises(ValueError):
        td.FourierDiff(2).divergence(torch.zeros(2, 3, 8, 8))


# ------------------------------------------------------------ point clouds


@pytest.mark.parametrize("regularize", [False, True])
@pytest.mark.parametrize("radius", [None, 0.3])
def test_non_uniform_fd(regularize, radius):
    rng = np.random.default_rng(4)
    points = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    values = (np.sin(3 * points[:, 0]) * np.cos(2 * points[:, 1])).astype(np.float32)
    kwargs = dict(num_neighbors=6, derivative_indices=(0, 1), radius=radius,
                  regularize_lstsq=regularize)
    idx, w = td.get_non_uniform_fd_weights(_t(points), **kwargs)
    jidx, jw = jd.get_non_uniform_fd_weights(jnp.asarray(points), **kwargs)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert w.shape == jw.shape == (40, 2, 6)
    got = td.non_uniform_fd(_t(points), _t(values), **kwargs).numpy()
    want = jd.non_uniform_fd(jnp.asarray(points), jnp.asarray(values), **kwargs)
    with jax.enable_x64(True):
        want64 = jd.non_uniform_fd(jnp.asarray(points, jnp.float64),
                                   jnp.asarray(values, jnp.float64), **kwargs)
    got64 = td.non_uniform_fd(_t(points).double(), _t(values).double(), **kwargs).numpy()
    _close(got64, want64, POINT_CLOUD_F64_TOL)
    if regularize:
        # the normal equations' ridge leaves them ill-conditioned in f32: the
        # port's answer is held to JAX's float64 one, no farther than JAX's own
        jax_err = np.abs(np.asarray(want, np.float64) - want64).max()
        assert np.abs(got - np.asarray(want64)).max() <= 2 * jax_err
    else:
        _close(got, want, POINT_CLOUD_TOL)


# ------------------------------------------------------------------ losses


def _value_and_grad(port_fn, jax_fn, arrays):
    """Value and gradient w.r.t. the first array, in both packages."""
    tensors = [_t(a) for a in arrays]
    tensors[0].requires_grad_()
    value = port_fn(*tensors)
    (grad,) = torch.autograd.grad(value, tensors[0])
    j_value, j_grad = jax.value_and_grad(
        lambda a: jax_fn(a, *[jnp.asarray(b) for b in arrays[1:]]))(jnp.asarray(arrays[0]))
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(j_value), rtol=1e-5)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-7 * np.abs(j_grad).max())


@pytest.mark.parametrize("domain", [1.0, [1.0, 2 * np.pi]])
def test_burgers_eqn_and_ic_losses(domain):
    u = _smooth(11, (3, 1, 16, 16), periodic=False)
    y = u + 0.1 * _smooth(12, (3, 1, 16, 16))
    port = tlosses.BurgersEqnLoss(visc=0.05, domain_length=domain)
    ref = jeq.BurgersEqnLoss(visc=0.05, domain_length=domain)
    _value_and_grad(port, ref, [u])
    _value_and_grad(tlosses.ICLoss(), jeq.ICLoss(), [u, y])
    with pytest.raises(NotImplementedError):
        tlosses.BurgersEqnLoss(method="autograd")(_t(u))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("kind", ["rel", "abs"])
def test_hdiv_loss(d, periodic, kind):
    shape = (2, d) + SHAPES[d][2:]
    x = np.concatenate([_smooth(40 + i, (2, 1) + SHAPES[d][2:], periodic) for i in range(d)], 1)
    y = x + 0.2 * np.concatenate([_smooth(50 + i, (2, 1) + SHAPES[d][2:]) for i in range(d)], 1)
    assert x.shape == shape
    kwargs = dict(d=d, measure=[1.0, 2.0, 0.5][:d], periodic_in_x=periodic,
                  periodic_in_y=not periodic, periodic_in_z=periodic)
    port, ref = tlosses.HdivLoss(**kwargs), jdl.HdivLoss(**kwargs)
    if kind == "rel":
        _value_and_grad(port, ref, [x, y])
    else:
        _value_and_grad(lambda a, b: port.abs(a, b, quadrature=0.25),
                        lambda a, b: ref.abs(a, b, quadrature=0.25), [x, y])
        _value_and_grad(port.abs, ref.abs, [x, y])
    assert port.name == ref.name


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_mse_loss(reduction):
    x, y = _smooth(60, SHAPES[2]), _smooth(61, SHAPES[2])
    _value_and_grad(tlosses.MSELoss(reduction), jdl.MSELoss(reduction), [x, y])
    with pytest.raises(ValueError):
        tlosses.MSELoss("max")


# -------------------------------------------------------------- meta losses


def test_weighted_sum_and_fieldwise_losses():
    x, y = _smooth(70, SHAPES[1]), _smooth(71, SHAPES[1])
    port = tlosses.WeightedSumLoss([tlosses.MSELoss(), tlosses.LpLoss(d=1)], [0.3, 0.7])
    ref = jmeta.WeightedSumLoss([jdl.MSELoss(), jdl.LpLoss(d=1)], [0.3, 0.7])
    _value_and_grad(port, ref, [x, y])
    _value_and_grad(tlosses.WeightedSumLoss([tlosses.MSELoss()] * 2),
                    jmeta.WeightedSumLoss([jdl.MSELoss()] * 2), [x, y])
    with pytest.raises(ValueError):
        tlosses.WeightedSumLoss([tlosses.MSELoss()], [0.5, 0.5])
    x, y = x.reshape(-1, 3), y.reshape(-1, 3)
    mappings = {"u": (slice(None), slice(0, 1)), "v": (slice(None), slice(2, 3))}
    port = tlosses.FieldwiseAggregatorLoss({"u": tlosses.MSELoss(), "v": tlosses.MSELoss()},
                                           mappings, logging=True)
    ref = jmeta.FieldwiseAggregatorLoss({"u": jdl.MSELoss(), "v": jdl.MSELoss()}, mappings,
                                        logging=True)
    (loss, record), (jloss, jrecord) = port(_t(x), _t(y)), ref(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert {k: float(v) for k, v in record.items()} == pytest.approx(
        {k: float(v) for k, v in jrecord.items()}, rel=1e-6)
    with pytest.raises(ValueError):
        tlosses.FieldwiseAggregatorLoss({"u": tlosses.MSELoss()}, {"v": 0})


@pytest.mark.parametrize("name", ["SoftAdapt", "Relobralo"])
@pytest.mark.parametrize("weights", [None, {"ic": 2.0}])
def test_adaptive_weights_follow_jax_step_by_step(name, weights):
    """Six steps from the same loss values (a lookback of ReLoBRaLo's fires
    at least once over them at beta 0.5)."""
    kwargs = {"beta": 0.5, "seed": 3} if name == "Relobralo" else {}
    port = getattr(tlosses, name)(num_losses=3, weights=weights, **kwargs)
    ref = getattr(jmeta, name)(num_losses=3, weights=weights, **kwargs)
    rng = np.random.default_rng(8)
    for step in range(6):
        vals = rng.uniform(0.05, 2.0, 3).astype(np.float32)
        keys = ("data", "ic", "equation")
        total, lmbda = port({k: torch.tensor(v) for k, v in zip(keys, vals)}, step=step)
        jtotal, jlmbda = ref({k: jnp.asarray(v) for k, v in zip(keys, vals)}, step=step)
        assert lmbda.dtype == torch.float32
        np.testing.assert_array_equal(lmbda.numpy(), np.asarray(jlmbda))
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    np.testing.assert_array_equal(port.prev_losses, ref.prev_losses)


def test_poisson_losses_are_not_ported():
    """The Poisson losses are ported now (they raised ``not_ported`` before
    the GNO slice): each builds, and the boundary loss is JAX's
    (tests/test_torch_gno_scripts.py holds all three to JAX)."""
    tlosses.PoissonInteriorLoss()
    tlosses.PoissonEqnLoss(boundary_weight=1.0, interior_weight=0.1)
    rng = np.random.default_rng(9)
    pred, y = (rng.standard_normal((1, 12, 1)).astype(np.float32) for _ in range(2))
    got = tlosses.PoissonBoundaryLoss()(torch.from_numpy(pred), 5, torch.from_numpy(y))
    want = jeq.PoissonBoundaryLoss()(jnp.asarray(pred), 5, jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
