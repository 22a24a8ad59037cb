"""The port's LpLoss, H1Loss and FiniteDiff against the JAX package's.

Both packages get the same numpy fields; values are compared directly and
gradients as ``torch.autograd.grad`` against ``jax.grad`` with respect to
the prediction. Tolerance: ``rtol=1e-5`` on values and ``rtol=1e-4,
atol=1e-7`` times the largest gradient entry on gradients (f32; the same
stencils and sums in another order, and a gradient divides by the
denominator's root, which the relative losses carry to ~1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.losses import differentiation as jd
from neuraloperator_tpu_torch.losses import FiniteDiff, H1Loss, LpLoss
from neuraloperator_tpu_torch.losses import data_losses as tl

torch.set_num_threads(1)

SHAPES = {1: (3, 2, 19), 2: (3, 2, 12, 9), 3: (2, 1, 7, 6, 5)}


def _fields(seed, d):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(SHAPES[d]).astype(np.float32)
    x = (y + 0.3 * rng.standard_normal(SHAPES[d])).astype(np.float32)
    return x, y


def _value_and_grad(port_fn, jax_fn, x, y):
    tx = torch.from_numpy(x).requires_grad_()
    value = port_fn(tx, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(value, tx)
    j_value, j_grad = jax.value_and_grad(lambda a: jax_fn(a, jnp.asarray(y)))(jnp.asarray(x))
    return (value.detach().numpy(), grad.numpy()), (np.asarray(j_value), np.asarray(j_grad))


def _check(port, ref):
    (value, grad), (j_value, j_grad) = port, ref
    assert value.shape == j_value.shape
    np.testing.assert_allclose(value, j_value, rtol=1e-5)
    np.testing.assert_allclose(grad, j_grad, rtol=1e-4, atol=1e-7 * np.abs(j_grad).max())


@pytest.mark.parametrize("d,axis", [(d, axis) for d in (1, 2, 3) for axis in range(d)])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("order", [1, 2])
def test_finite_diff(d, axis, periodic, order):
    u, _ = _fields(0, d)
    h = [0.1, 0.25, 0.5][:d]
    kwargs = dict(periodic_in_x=periodic, periodic_in_y=not periodic, periodic_in_z=periodic)
    port, ref = FiniteDiff(d, h, **kwargs), jd.FiniteDiff(d, h, **kwargs)
    name = ["dx", "dy", "dz"][axis]
    got = getattr(port, name)(torch.from_numpy(u), order).numpy()
    want = np.asarray(getattr(ref, name)(jnp.asarray(u), order))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_lp_loss_rel(d, p, reduction):
    x, y = _fields(1, d)
    port, ref = LpLoss(d=d, p=p, reduction=reduction), jl.LpLoss(d=d, p=p, reduction=reduction)
    _check(*_value_and_grad(port, ref, x, y))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_lp_loss_abs(d):
    x, y = _fields(2, d)
    port, ref = LpLoss(d=d, measure=2.0), jl.LpLoss(d=d, measure=2.0)
    _check(*_value_and_grad(port.abs, ref.abs, x, y))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_h1_loss_rel(d, periodic, reduction):
    x, y = _fields(3, d)
    kwargs = dict(d=d, reduction=reduction, periodic_in_x=periodic, periodic_in_y=periodic,
                  periodic_in_z=not periodic)
    port, ref = H1Loss(**kwargs), jl.H1Loss(**kwargs)
    _check(*_value_and_grad(port, ref, x, y))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("periodic", [True, False])
def test_h1_loss_with_precomputed_ynorm_sq(d, periodic):
    """``rel(..., ynorm_sq=...)``: one stencil pass on the difference, the
    denominator given; equal to the JAX path and to the port's two-pass one."""
    x, y = _fields(4, d)
    kwargs = dict(d=d, measure=[1.0, 2.0, 0.5][:d], periodic_in_x=periodic,
                  periodic_in_y=not periodic, periodic_in_z=periodic)
    port, ref = H1Loss(**kwargs), jl.H1Loss(**kwargs)
    ynorm = port.ynorm_sq(torch.from_numpy(y))
    j_ynorm = ref.ynorm_sq(jnp.asarray(y))
    np.testing.assert_allclose(ynorm.numpy(), np.asarray(j_ynorm), rtol=1e-5)
    got, want = _value_and_grad(lambda a, b: port(a, b, ynorm_sq=ynorm),
                                lambda a, b: ref(a, b, ynorm_sq=j_ynorm), x, y)
    _check(got, want)
    two_pass = port(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got[0], two_pass.detach().numpy(), rtol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_h1_loss_abs_and_quadrature(d):
    x, y = _fields(5, d)
    port, ref = H1Loss(d=d, periodic_in_x=False), jl.H1Loss(d=d, periodic_in_x=False)
    _check(*_value_and_grad(port.abs, ref.abs, x, y))
    _check(*_value_and_grad(lambda a, b: port.abs(a, b, quadrature=0.5),
                            lambda a, b: ref.abs(a, b, quadrature=0.5), x, y))


def test_names_and_unported_losses():
    assert LpLoss(d=2, p=2).name == jl.LpLoss(d=2, p=2).name
    assert H1Loss(d=3).name == jl.H1Loss(d=3).name
    with pytest.raises(ValueError):
        H1Loss(d=4)
    with pytest.raises(ValueError):
        LpLoss(reduction="max")
    assert tl.PointwiseQuantileLoss(0.1).name == jl.PointwiseQuantileLoss(0.1).name
    assert tl.HdivLoss(d=2).name == jl.HdivLoss(d=2).name
    assert tl.MSELoss().name == jl.MSELoss().name
    from neuraloperator_tpu_torch import losses as port_losses

    # the Poisson losses were stubs raising not_ported before the GNO slice
    port_losses.PoissonInteriorLoss()
    port_losses.PoissonBoundaryLoss()
    port_losses.PoissonEqnLoss(boundary_weight=1.0, interior_weight=0.1)
