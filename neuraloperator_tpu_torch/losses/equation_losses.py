"""Physics losses (port of ``neuraloperator_tpu/losses/equation_losses.py``).

``BurgersEqnLoss``: the finite-difference residual of 1-D viscous Burgers
on a (time, space) grid; ``ICLoss``: the initial condition's error. The
Poisson losses (JAX's forward-mode derivatives of a query function) come
with the GNO family and raise here.
"""

from .._common import not_ported
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


def _unported(name: str):
    def __init__(self, *args, **kwargs):
        raise not_ported(name, "the other families")

    return type(name, (), {"__init__": __init__, "__doc__": f"{name}: not ported yet."})


PoissonInteriorLoss = _unported("PoissonInteriorLoss")
PoissonBoundaryLoss = _unported("PoissonBoundaryLoss")
PoissonEqnLoss = _unported("PoissonEqnLoss")
