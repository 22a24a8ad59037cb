"""The spherical convolution over a latitude-sharded sphere (port of
``neuraloperator_tpu/parallel/distributed_sht.py``).

The latitude axis is split over the mesh's model group, and the real SHT
of each rank's band is

    local truncated rDFT along the (whole) longitude
 -> the kept orders m, zero-padded to a multiple of the group size
    (before the exchange: only they cross between ranks)
 -> all_to_all: gather the latitude, split the orders
 -> the Legendre analysis over the whole latitude for this rank's orders
 -> the per-degree dhconv channel contraction (the weight whole on every
    rank, its gradient summed over the group: each rank's orders add theirs)
 -> the Legendre synthesis, all_to_all back, the truncated inverse rDFT
    along the longitude (Hermitian-enforced).

As in ``distributed_fft.py``, the function takes and returns the whole
(model-replicated) arrays, the latitude scattered over the model ranks and
gathered back, every rank ending with the whole gradient.
"""

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from .._common import resolve_device
from . import comm
from . import mesh as mesh_lib
from .distributed_fft import _model_group, all_to_all, pad_to_multiple


def _local_spherical_conv(x_local, w_re, w_im, analysis, synthesis, *, mmax: int, nlon: int,
                          group):
    """One rank's body: x_local (b, c, lat_local, nlon); the whole weight
    (i, o, lmax); analysis (lmax, m_pad / P, nlat) and synthesis (nlat, lmax,
    m_pad / P), this rank's orders."""
    from ..ops.complex_einsum import complex_einsum
    from ..ops.fourier import rdft_gather_last, rdft_scatter_last

    m_avail = min(mmax, nlon // 2 + 1)
    m_pad = pad_to_multiple(mmax, dist.get_world_size(group))
    Fr, Fi = rdft_gather_last(x_local.float(), m_avail, "forward")
    Fr = torch.nn.functional.pad(Fr, (0, m_pad - m_avail))
    Fi = torch.nn.functional.pad(Fi, (0, m_pad - m_avail))
    Fr, Fi = all_to_all(Fr, 3, 2, group), all_to_all(Fi, 3, 2, group)
    fr = torch.einsum("lmj,bcjm->bclm", analysis, Fr)
    fi = torch.einsum("lmj,bcjm->bclm", analysis, Fi)
    out_r, out_i = complex_einsum("bilm,iol->bolm", (fr, fi), (w_re, w_im))
    Gr = torch.einsum("jlm,bclm->bcjm", synthesis, out_r)
    Gi = torch.einsum("jlm,bclm->bcjm", synthesis, out_i)
    Gr, Gi = all_to_all(Gr, 2, 3, group), all_to_all(Gi, 2, 3, group)
    return rdft_scatter_last(Gr[..., :m_avail], Gi[..., :m_avail], nlon, "forward")


def distributed_spherical_conv(x: torch.Tensor, weight, lmax: int, mmax: int, mesh,
                               grid: str = "equiangular", axis_name: str = "model"
                               ) -> torch.Tensor:
    """Latitude-sharded dhconv spherical convolution over the model group.

    x: (b, c, nlat, nlon), the same on every model rank, nlat divisible by
    the group size; weight: complex (in, out, lmax), or its (re, im).
    Returns (b, out, nlat, nlon): ``sht -> contract_dhconv -> isht`` at the
    same (lmax, mmax, grid).
    """
    from ..ops.sht import _sht_matrices

    group, size = _model_group(mesh, axis_name)
    _, _, nlat, nlon = x.shape
    if nlat % size:
        raise ValueError("nlat must divide the model axis size")
    m_pad = pad_to_multiple(mmax, size)
    analysis, synthesis = _sht_matrices(nlat, lmax, mmax, grid, x.device, torch.float32)
    analysis = torch.nn.functional.pad(analysis, (0, 0, 0, m_pad - mmax))
    synthesis = torch.nn.functional.pad(synthesis, (0, m_pad - mmax))
    chunk, start = m_pad // size, dist.get_rank(group) * (m_pad // size)
    analysis = analysis.narrow(1, start, chunk)
    synthesis = synthesis.narrow(2, start, chunk)
    w_re, w_im = (weight.real, weight.imag) if torch.is_tensor(weight) else weight
    w_re = comm.copy_to_model_parallel_region(w_re.float(), group)
    w_im = comm.copy_to_model_parallel_region(w_im.float(), group)
    x_local = comm.scatter_to_model_parallel_region(x, 2, group)
    y = _local_spherical_conv(x_local, w_re, w_im, analysis, synthesis, mmax=mmax, nlon=nlon,
                              group=group)
    return comm.gather_from_model_parallel_region(y, 2, group)


class DistributedSphericalConv(nn.Module):
    """A ``conv_module`` for the SFNO running :func:`distributed_spherical_conv`
    on the current mesh at model size > 1, and the local SHT path otherwise
    (no mesh, or model size 1), with the dense ``SphericalConv``'s
    parameters (``w_weight`` (2, in, out, lmax) and ``bias`` (out, 1, 1)).
    ``n_modes`` = (lmax, m): ``max(m // 2, 1)`` orders are kept. Dense dhconv
    weights on one grid only: the options the JAX module refuses raise."""

    def __init__(self, in_channels: int, out_channels: int, n_modes, max_n_modes=None,
                 use_bias: bool = True, separable: bool = False,
                 resolution_scaling_factor=None, fno_block_precision: str = "full",
                 rank=1.0, factorization: Optional[str] = None,
                 implementation: str = "reconstructed", fixed_rank_modes=False,
                 complex_data: bool = False, init_std="auto", sht_norm: str = "ortho",
                 sht_grids="equiangular", enforce_hermitian_symmetry: bool = True,
                 fft_norm: str = "forward", *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        from ..layers import _init

        super().__init__()
        del rank, implementation, fixed_rank_modes, init_std, fno_block_precision
        del enforce_hermitian_symmetry, fft_norm
        self.n_modes = tuple(int(m) for m in n_modes)
        bad = {
            "separable": separable,
            "factorization": factorization not in (None, "dense"),
            "complex_data": complex_data,
            "resolution_scaling_factor": resolution_scaling_factor is not None,
            "max_n_modes": max_n_modes is not None
            and tuple(max_n_modes) != tuple(self.n_modes),
            "sht_grids": not isinstance(sht_grids, str),
        }
        unsupported = [k for k, v in bad.items() if v]
        if unsupported:
            raise ValueError("DistributedSphericalConv does not support: "
                             + ", ".join(unsupported))
        self.in_channels, self.out_channels = in_channels, out_channels
        self.sht_norm, self.grid = sht_norm, sht_grids
        self.lmax, self.mmax = self.n_modes[0], max(self.n_modes[1] // 2, 1)
        std = (2 / (in_channels + out_channels)) ** 0.5
        device = resolve_device(device)
        self.w_weight = _init.normal((2, in_channels, out_channels, self.lmax), std, device,
                                     generator)
        self.bias = (_init.normal((out_channels, 1, 1), std, device, generator)
                     if use_bias else None)

    def forward(self, x: torch.Tensor, output_shape=None, n_modes=None) -> torch.Tensor:
        from ..layers.spherical_convolution import contract_dhconv
        from ..ops.sht import isht, sht

        if output_shape is not None or n_modes is not None:
            raise ValueError("DistributedSphericalConv does not support per-call "
                             "output_shape/n_modes overrides")
        w = (self.w_weight[0].float(), self.w_weight[1].float())
        mesh = mesh_lib.get_mesh()
        if mesh is not None and mesh.shape[mesh_lib.MODEL_AXIS] > 1:
            y = distributed_spherical_conv(x, w, self.lmax, self.mmax, mesh, grid=self.grid)
        else:
            flm = sht(x, lmax=self.lmax, mmax=self.mmax, grid=self.grid, norm=self.sht_norm)
            y = isht(contract_dhconv(flm, w), nlat=x.shape[-2], nlon=x.shape[-1],
                     grid=self.grid, norm=self.sht_norm)
        if self.bias is not None:
            y = y + self.bias[None]
        return y

    def transform(self, x: torch.Tensor, output_shape=None) -> torch.Tensor:
        """The skip branch's resolution: the identity (no scaling)."""
        return x


__all__ = ["DistributedSphericalConv", "distributed_spherical_conv"]
