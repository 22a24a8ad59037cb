"""Optimal-transport maps between a latent sphere grid and a mesh, for OTNO
(port of ``neuraloperator_tpu/data/datasets/ot_datamodule.py``).

An entropic OT plan between a uniform latent grid on a sphere wrapping the
mesh and the mesh's vertices, by log-domain Sinkhorn iterations; the
encoder map (latent cell -> its most likely vertex) and the decoder map
(vertex -> its most likely latent cell) are argmaxes of the plan.

``sinkhorn_log`` on numpy arrays is the JAX package's function, copied: the
plain version. On torch tensors it runs the same iteration in their dtype
on their device (``torch.logsumexp`` where numpy reduces with
``np.logaddexp``), with the same ``tol`` stop on ``max|f - f_prev|`` and
the same ``1e-300`` guards. ``OTDataModule`` builds the sphere, its centre
and radius on the host in numpy, as the JAX module does (so the cost matrix
holds the same numbers), and solves in float64 on ``device``; its plan and
maps stay there. The two solvers round differently in the last bits, so a
row or column of the plan whose two largest entries lie within rounding
may pick another argmax.
"""

from typing import Optional, Union

import numpy as np
import torch

from ..._common import resolve_device

Array = Union[np.ndarray, torch.Tensor]


def sinkhorn_log(
    a: Array,
    b: Array,
    C: Array,
    reg: float = 1e-2,
    n_iters: int = 500,
    tol: float = 1e-7,
) -> Array:
    """Entropic OT plan via log-domain Sinkhorn iterations.

    a: (n,) source weights; b: (m,) target weights; C: (n, m) cost matrix,
    all numpy arrays or all torch tensors. Returns the transport plan P
    with marginals ~ (a, b), of C's kind.
    """
    if isinstance(C, torch.Tensor):
        return _sinkhorn_log_torch(a, b, C, reg, n_iters, tol)
    f = np.zeros_like(a)
    g = np.zeros_like(b)
    log_a = np.log(a + 1e-300)
    log_b = np.log(b + 1e-300)
    M = -C / reg
    for _ in range(n_iters):
        f_prev = f
        # f update: logsumexp over columns
        f = reg * (
            log_a
            - np.logaddexp.reduce((M + g[None, :] / reg), axis=1)
        )
        g = reg * (
            log_b
            - np.logaddexp.reduce((M + f[:, None] / reg), axis=0)
        )
        if np.abs(f - f_prev).max() < tol:
            break
    P = np.exp(M + f[:, None] / reg + g[None, :] / reg)
    return P


def _sinkhorn_log_torch(a, b, C, reg, n_iters, tol):
    """The numpy iteration on tensors; the stop test reads one scalar from
    the device per iteration."""
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    log_a = torch.log(a + 1e-300)
    log_b = torch.log(b + 1e-300)
    M = -C / reg
    for _ in range(n_iters):
        f_prev = f
        f = reg * (log_a - torch.logsumexp(M + g[None, :] / reg, dim=1))
        g = reg * (log_b - torch.logsumexp(M + f[:, None] / reg, dim=0))
        if float((f - f_prev).abs().max()) < tol:
            break
    return torch.exp(M + f[:, None] / reg + g[None, :] / reg)


def latent_sphere(vertices: np.ndarray, latent_size: int,
                  expand_factor: float = 1.0) -> np.ndarray:
    """The ``latent_size``² grid on the unit sphere, centred on the mesh
    and scaled to its largest radius (``(latent_size², 3)``, float64): the
    JAX module's numpy, in its dtypes."""
    theta = np.arccos(1 - 2 * (np.arange(latent_size) + 0.5) / latent_size)
    phi = 2 * np.pi * (np.arange(latent_size) + 0.5) / latent_size
    T, P = np.meshgrid(theta, phi, indexing="ij")
    sphere = np.stack(
        [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], axis=-1,
    ).reshape(-1, 3)
    center = vertices.mean(0)
    radius = np.linalg.norm(vertices - center, axis=1).max()
    return center + expand_factor * radius * sphere


def cost_matrix(source: Array, vertices: Array) -> Array:
    """Squared distances (n_latent, n_vertices)."""
    return ((source[:, None] - vertices[None]) ** 2).sum(-1)


class OTDataModule:
    """OT maps between the latent grid and the vertices of one mesh.

    ``vertices`` (n, 3) numpy. The plan (float64) and the maps
    ``ind_enc`` (latent cell -> vertex) and ``ind_dec`` (vertex -> latent
    cell), int64, are tensors on ``device``; ``source`` is the latent grid
    in numpy (float64).
    """

    def __init__(
        self,
        vertices: np.ndarray,
        latent_size: int,
        reg: float = 1e-2,
        expand_factor: float = 1.0,
        n_iters: int = 300,
        *,
        device="cuda",
    ):
        device = resolve_device(device)
        vertices = np.asarray(vertices)
        self.latent_size = latent_size
        n_latent = latent_size * latent_size
        self.source = latent_sphere(vertices, latent_size, expand_factor)
        src = torch.from_numpy(self.source).to(device)
        verts = torch.from_numpy(vertices).to(device=device, dtype=torch.float64)
        C = cost_matrix(src, verts)
        a = torch.full((n_latent,), 1.0 / n_latent, dtype=torch.float64, device=device)
        b = torch.full((len(vertices),), 1.0 / len(vertices), dtype=torch.float64,
                       device=device)
        self.plan = sinkhorn_log(a, b, C, reg=reg, n_iters=n_iters)
        # encoder: most likely mesh point per latent cell
        self.ind_enc = torch.argmax(self.plan, dim=1)
        # decoder: most likely latent cell per mesh vertex
        self.ind_dec = torch.argmax(self.plan, dim=0)

    def transported_features(
        self, vertices: Array, extras: Optional[Array] = None
    ) -> torch.Tensor:
        """OTNO's input (1, C, s, s), float32, on the plan's device: the
        latent grid's coordinates, the transported vertices (and
        ``extras`` gathered at them)."""
        s = self.latent_size
        device = self.plan.device

        def gathered(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.float64)[self.ind_enc]

        feats = [torch.from_numpy(self.source).to(device), gathered(vertices)]
        if extras is not None:
            feats.append(gathered(extras))
        out = torch.cat(feats, dim=-1)  # (s*s, C)
        return out.T.reshape(1, -1, s, s).float()
