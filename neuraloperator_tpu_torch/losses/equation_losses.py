"""Physics losses (port of ``neuraloperator_tpu/losses/equation_losses.py``).

``BurgersEqnLoss``: the finite-difference residual of 1-D viscous Burgers
on a (time, space) grid; ``ICLoss``: the initial condition's error; the
nonlinear Poisson losses of the GNO family: ``PoissonInteriorLoss`` (the
residual at interior query points, through derivatives of the model with
respect to its queries), ``PoissonBoundaryLoss`` and ``PoissonEqnLoss``.
"""

import torch

from .differentiation import FiniteDiff


def mse_loss(a, b):
    return ((a - b) ** 2).mean()


class BurgersEqnLoss:
    """The residual ``u_t + u u_x - visc u_xx`` of ``u`` (batch, 1, nt, nx),
    one-sided at the time and space boundaries, through ``loss`` (mean
    squared error by default). ``domain_length`` is (T, L) or one length
    for both; dt = T / (nt - 1), dx = L / nx."""

    def __init__(self, visc=0.01, method="fdm", loss=mse_loss, domain_length=1.0):
        self.visc = visc
        self.method = method
        self.loss = loss
        if not isinstance(domain_length, (tuple, list)):
            domain_length = [domain_length] * 2
        self.domain_length = list(domain_length)

    def fdm(self, u):
        u = u.squeeze(1)
        _, nt, nx = u.shape
        dt = self.domain_length[0] / (nt - 1)
        dx = self.domain_length[1] / nx
        fd2d = FiniteDiff(dim=2, h=(dt, dx), periodic_in_x=False, periodic_in_y=False)
        dudt = fd2d.dx(u)
        dudx = fd2d.dy(u)
        dudxx = fd2d.dy(u, order=2)
        rhs = -dudx * u + self.visc * dudxx
        return self.loss(dudt, rhs)

    def __call__(self, y_pred, **kwargs):
        if self.method == "fdm":
            return self.fdm(y_pred)
        raise NotImplementedError(f"method {self.method}")


class ICLoss:
    """``loss`` between the t=0 slices of ``y_pred`` and ``y`` (b, c, t, ...)."""

    def __init__(self, loss=mse_loss):
        self.loss = loss

    def __call__(self, y_pred, y, **kwargs):
        return self.loss(y_pred[:, :, 0], y[:, :, 0])


class PoissonInteriorLoss:
    """Interior residual of the nonlinear Poisson equation
    div((1 + 0.1 u²) grad u) = f, expanded as Δu + 0.1 u² Δu + 0.2 u |grad u|².

    ``u_fn`` maps query coordinates (n, 2) to u (n,) for one sample (a
    closure over the model and its other inputs), as in the JAX package.
    JAX differentiates it point by point (``jax.grad`` and ``jacfwd`` of
    ``u_fn(q[None])``, vmapped); the port evaluates ``u_fn`` once on the
    whole batch of queries and differentiates the sum of its outputs with
    ``torch.autograd.grad(..., create_graph=True)``: the gradient, then each
    second derivative on the diagonal. The two agree because every output
    of the GNO models depends on its own query alone (each query's
    neighbours and embedding are its own), so the gradient of the sum is
    each point's gradient. The graph is kept, so the loss trains the model.
    """

    def __init__(self, loss=mse_loss):
        self.loss = loss

    def __call__(self, u_fn, output_queries, output_source_terms_domain, **kwargs):
        queries = output_queries.reshape(-1, output_queries.shape[-1]).detach()
        queries.requires_grad_(True)
        u = u_fn(queries).reshape(-1)
        du = torch.autograd.grad(u.sum(), queries, create_graph=True)[0]
        laplacian = sum(
            torch.autograd.grad(du[:, i].sum(), queries, create_graph=True)[0][:, i]
            for i in range(2))
        norm_grad_sq = (du ** 2).sum(dim=-1)
        lhs = laplacian + 0.1 * (u ** 2) * laplacian + 0.2 * u * norm_grad_sq
        return self.loss(lhs, output_source_terms_domain.reshape(lhs.shape))


class PoissonBoundaryLoss:
    """Dirichlet boundary loss over the first ``num_boundary * out_sub_level``
    points of ``y_pred`` and ``y`` (1, n, 1)."""

    def __init__(self, loss=mse_loss):
        self.loss = loss

    def __call__(self, y_pred, num_boundary, y, out_sub_level=1.0, **kwargs):
        nb = int(num_boundary * out_sub_level)
        boundary_pred = y_pred.squeeze(0).squeeze(-1)[:nb]
        y_bound = y.squeeze(0).squeeze(-1)[:nb]
        return self.loss(boundary_pred, y_bound)


class PoissonEqnLoss:
    """``interior_weight`` times the interior residual plus
    ``boundary_weight`` times the boundary loss."""

    def __init__(self, boundary_weight: float, interior_weight: float, base_loss=mse_loss):
        self.boundary_weight = boundary_weight
        self.interior_weight = interior_weight
        self.boundary_loss = PoissonBoundaryLoss(loss=base_loss)
        self.interior_loss = PoissonInteriorLoss(loss=base_loss)

    def __call__(self, u_fn, boundary_pred, y_boundary, num_boundary, **kwargs):
        interior = self.interior_weight * self.interior_loss(u_fn, **kwargs)
        bc = self.boundary_weight * self.boundary_loss(boundary_pred, num_boundary=num_boundary,
                                                       y=y_boundary)
        return interior + bc
