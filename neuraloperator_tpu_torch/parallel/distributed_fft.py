"""The spectral convolution over a height-sharded domain (port of
``neuraloperator_tpu/parallel/distributed_fft.py``).

The spatial height axis is split over the mesh's model group, and the 2-D
transform of each rank's slab is

    local rfft along the (whole) width
 -> the kept width modes, zero-padded to a multiple of the group size
    (before the exchange, so that only they cross between ranks)
 -> all_to_all: gather the height, split the kept width modes
 -> local fft along the height, the centered height modes gathered
 -> per-mode channel contraction with this rank's width modes of the weight
    (``ops/contractions.contract_dense``: K1, and K2 and K3 backward, on the card)
 -> the inverse path: height modes scattered, inverse fft along the
    height, all_to_all back, width spectrum zero-padded, irfft.

The JAX package runs the body under ``shard_map`` and XLA transposes each
``all_to_all`` for the gradient; here :func:`all_to_all` is an autograd
``Function`` whose backward is the reverse exchange. As in JAX, the
functions take and return the whole (model-replicated) arrays: the input's
height is scattered over the model ranks and the output gathered
(``comm.scatter_to_model_parallel_region`` /
``gather_from_model_parallel_region``), and the weight's width modes are
scattered too, so every rank ends with the whole gradient of each. The 3-D
form transforms the depth locally as well; only the height crosses ranks.

:func:`halo_exchange` pads each rank's slab of a ring with its
neighbours' edge rows (``batch_isend_irecv``), its backward sending the
halos' gradients back.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .._common import resolve_device
from . import comm
from . import mesh as mesh_lib


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.split_dim, ctx.concat_dim, ctx.group = split_dim, concat_dim, group
        return _exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.concat_dim, ctx.split_dim, ctx.group), None, None, None


def _exchange(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    size = dist.get_world_size(group)
    inputs = [c.contiguous() for c in torch.chunk(x, size, dim=split_dim)]
    outputs = [torch.empty_like(inputs[0]) for _ in range(size)]
    dist.all_to_all(outputs, inputs, group=group)
    return torch.cat(outputs, dim=concat_dim)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)``: ``x`` split into equal chunks
    along ``split_dim``, chunk r sent to rank r of ``group``, the received
    chunks concatenated along ``concat_dim`` in rank order. Its backward is
    the reverse exchange."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def _fft_axis(re, im, axis: int, inverse: bool = False):
    z = torch.complex(re, im)
    z = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=axis, norm="forward")
    return z.real, z.imag


def _gather_center(a: torch.Tensor, axis: int, kept: int, size: int) -> torch.Tensor:
    """The centered ``kept`` modes of a full-spectrum axis (corner concat)."""
    neg = kept // 2
    pos = kept - neg
    return torch.cat([a.narrow(axis, size - neg, neg), a.narrow(axis, 0, pos)], dim=axis)


def _scatter_center(a: torch.Tensor, axis: int, kept: int, size: int) -> torch.Tensor:
    """Inverse of :func:`_gather_center`: the dropped modes zero-filled."""
    neg = kept // 2
    mid = list(a.shape)
    mid[axis] = size - kept
    return torch.cat([a.narrow(axis, neg, kept - neg), a.new_zeros(mid), a.narrow(axis, 0, neg)],
                     dim=axis)


def _width_spectrum(x: torch.Tensor, kept: int, padded: int):
    """The kept rfft modes of the last axis, zero-padded to ``padded``."""
    xf = torch.fft.rfft(x.float(), dim=-1, norm="forward")[..., :kept]
    pad = [0, padded - kept]
    return (torch.nn.functional.pad(xf.real, pad), torch.nn.functional.pad(xf.imag, pad))


def _inverse_width(re, im, kept: int, width: int) -> torch.Tensor:
    half = width // 2 + 1
    pad = [0, half - kept]
    spec = torch.complex(torch.nn.functional.pad(re[..., :kept], pad),
                         torch.nn.functional.pad(im[..., :kept], pad))
    return torch.fft.irfft(spec, n=width, dim=-1, norm="forward")


def _contract(re, im, w_re, w_im):
    from ..ops.contractions import contract_dense

    return contract_dense((re, im), (w_re, w_im))


def _weight_parts(weight, kw: int, kw_pad: int, group):
    """This rank's width modes of the (padded) weight, whose backward
    all-gathers the gradient; ``weight`` is complex, or its (re, im)."""
    w_re, w_im = (weight.real, weight.imag) if torch.is_tensor(weight) else weight
    pad = [0, kw_pad - kw]
    w_re = torch.nn.functional.pad(w_re.float(), pad)
    w_im = torch.nn.functional.pad(w_im.float(), pad)
    return (comm.scatter_to_model_parallel_region(w_re, -1, group),
            comm.scatter_to_model_parallel_region(w_im, -1, group))


def _local_spectral_conv2d(x_local, w_re, w_im, *, n_modes, height, width, group):
    """One rank's body: x_local (b, c, h_local, w); w (i, o, kh, kw_pad / P)."""
    size = dist.get_world_size(group)
    kh, kw = n_modes
    re, im = _width_spectrum(x_local, kw, pad_to_multiple(kw, size))
    re, im = all_to_all(re, 3, 2, group), all_to_all(im, 3, 2, group)
    re, im = _fft_axis(re, im, 2)
    re, im = _gather_center(re, 2, kh, height), _gather_center(im, 2, kh, height)
    out_re, out_im = _contract(re, im, w_re, w_im)
    out_re = _scatter_center(out_re, 2, kh, height)
    out_im = _scatter_center(out_im, 2, kh, height)
    out_re, out_im = _fft_axis(out_re, out_im, 2, inverse=True)
    out_re, out_im = all_to_all(out_re, 2, 3, group), all_to_all(out_im, 2, 3, group)
    return _inverse_width(out_re, out_im, kw, width)


def _local_spectral_conv3d(x_local, w_re, w_im, *, n_modes, depth, height, width, group):
    """One rank's body: x_local (b, c, d, h_local, w); w (i, o, kd, kh, kw_pad / P)."""
    size = dist.get_world_size(group)
    kd, kh, kw = n_modes
    re, im = _width_spectrum(x_local, kw, pad_to_multiple(kw, size))
    re, im = _fft_axis(re, im, 2)
    re, im = _gather_center(re, 2, kd, depth), _gather_center(im, 2, kd, depth)
    re, im = all_to_all(re, 4, 3, group), all_to_all(im, 4, 3, group)
    re, im = _fft_axis(re, im, 3)
    re, im = _gather_center(re, 3, kh, height), _gather_center(im, 3, kh, height)
    out_re, out_im = _contract(re, im, w_re, w_im)
    out_re = _scatter_center(out_re, 3, kh, height)
    out_im = _scatter_center(out_im, 3, kh, height)
    out_re, out_im = _fft_axis(out_re, out_im, 3, inverse=True)
    out_re, out_im = all_to_all(out_re, 3, 4, group), all_to_all(out_im, 3, 4, group)
    out_re = _scatter_center(out_re, 2, kd, depth)
    out_im = _scatter_center(out_im, 2, kd, depth)
    out_re, out_im = _fft_axis(out_re, out_im, 2, inverse=True)
    return _inverse_width(out_re, out_im, kw, width)


def _model_group(mesh, axis_name: str):
    if axis_name != mesh_lib.MODEL_AXIS:
        raise ValueError(f"the sharded FFT runs over the {mesh_lib.MODEL_AXIS!r} axis, "
                         f"got {axis_name!r}")
    return mesh.model_group, mesh.shape[mesh_lib.MODEL_AXIS]


def distributed_spectral_conv2d(x: torch.Tensor, weight, n_modes: Tuple[int, int], mesh,
                                axis_name: str = "model") -> torch.Tensor:
    """Sharded-FFT 2-D spectral convolution over the mesh's model group.

    x: (b, c, h, w), the same on every model rank, h divisible by the group
    size; weight: complex (in, out, kept_h, kept_w) (or its (re, im)) with
    kept_w the unpadded rfft-halved width mode count. Returns (b, out, h, w).
    """
    group, size = _model_group(mesh, axis_name)
    _, _, height, width = x.shape
    kh, kw = n_modes
    if height % size:
        raise ValueError("height must divide the model axis size")
    w_re, w_im = _weight_parts(weight, kw, pad_to_multiple(kw, size), group)
    x_local = comm.scatter_to_model_parallel_region(x, 2, group)
    y = _local_spectral_conv2d(x_local, w_re, w_im, n_modes=(kh, kw), height=height,
                               width=width, group=group)
    return comm.gather_from_model_parallel_region(y, 2, group)


def distributed_spectral_conv3d(x: torch.Tensor, weight, n_modes: Tuple[int, int, int], mesh,
                                axis_name: str = "model") -> torch.Tensor:
    """Sharded-FFT 3-D spectral convolution: x (b, c, d, h, w) with h
    divisible by the model group's size; weight complex (in, out, kd, kh,
    kw) in centered kd/kh order, kw unpadded. Returns (b, out, d, h, w)."""
    group, size = _model_group(mesh, axis_name)
    _, _, depth, height, width = x.shape
    kd, kh, kw = n_modes
    if height % size:
        raise ValueError("height must divide the model axis size")
    w_re, w_im = _weight_parts(weight, kw, pad_to_multiple(kw, size), group)
    x_local = comm.scatter_to_model_parallel_region(x, 3, group)
    y = _local_spectral_conv3d(x_local, w_re, w_im, n_modes=(kd, kh, kw), depth=depth,
                               height=height, width=width, group=group)
    return comm.gather_from_model_parallel_region(y, 3, group)


class _DistributedSpectralConv(nn.Module):
    """The dense ``SpectralConv``'s parameters (``w_weight`` (2, in, out,
    kept...) and ``bias`` (out, 1...)) run through the sharded FFT on the
    current mesh at model size > 1, and through the local spectral
    convolution otherwise (no mesh, or model size 1), so one model and its
    weights run anywhere. Dense real-input weights only: the options the
    JAX module refuses raise here too."""

    n_dim = 2

    def __init__(self, in_channels: int, out_channels: int, n_modes: Sequence[int],
                 max_n_modes=None, use_bias: bool = True, separable: bool = False,
                 resolution_scaling_factor=None, fno_block_precision: str = "full",
                 rank=1.0, factorization: Optional[str] = None,
                 implementation: str = "reconstructed", fixed_rank_modes=False,
                 complex_data: bool = False, init_std="auto", fft_norm: str = "forward",
                 *, device="cuda", generator: Optional[torch.Generator] = None):
        from ..layers import _init

        super().__init__()
        del rank, implementation, fixed_rank_modes, init_std  # fields the JAX module ignores
        self.in_channels, self.out_channels = in_channels, out_channels
        self.n_modes = tuple(int(m) for m in n_modes)
        self.fno_block_precision, self.fft_norm = fno_block_precision, fft_norm
        self._check(max_n_modes, separable, resolution_scaling_factor, factorization,
                    complex_data)
        std = (2 / (in_channels + out_channels)) ** 0.5
        device = resolve_device(device)
        self.w_weight = _init.normal((2, in_channels, out_channels, *self.kept_modes), std,
                                     device, generator)
        self.bias = (_init.normal((out_channels,) + (1,) * self.n_dim, std, device, generator)
                     if use_bias else None)

    @property
    def kept_modes(self) -> Tuple[int, ...]:
        return (*self.n_modes[:-1], self.n_modes[-1] // 2 + 1)

    def _check(self, max_n_modes, separable, resolution_scaling_factor, factorization,
               complex_data) -> None:
        name = type(self).__name__
        if len(self.n_modes) != self.n_dim:
            raise ValueError(f"{name} is {self.n_dim}-D only")
        bad = {
            "separable": separable,
            "factorization": factorization not in (None, "dense"),
            "complex_data": complex_data,
            "max_n_modes": max_n_modes is not None
            and tuple(max_n_modes) != tuple(self.n_modes),
            "resolution_scaling_factor": resolution_scaling_factor is not None,
        }
        unsupported = [k for k, v in bad.items() if v]
        if unsupported:
            raise ValueError(f"{name} does not support: " + ", ".join(unsupported))

    def _sharded(self, x, mesh):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, output_shape=None, n_modes=None) -> torch.Tensor:
        from ..layers.spectral_convolution import spectral_conv_forward
        from ..tensor.factorized import FactorizationSpec

        if output_shape is not None or n_modes is not None:
            raise ValueError(f"{type(self).__name__} does not support per-call "
                             "output_shape/n_modes overrides")
        mesh = mesh_lib.get_mesh()
        if mesh is not None and mesh.shape[mesh_lib.MODEL_AXIS] > 1:
            y = self._sharded(x, mesh)
        else:
            kept = list(self.kept_modes)
            y = spectral_conv_forward(
                x, FactorizationSpec("dense", (self.in_channels, self.out_channels, *kept)),
                {"weight": (self.w_weight[0], self.w_weight[1])}, None,
                n_modes=kept, max_n_modes=kept, fft_norm=self.fft_norm,
                fno_block_precision=self.fno_block_precision,
                enforce_hermitian_symmetry=False)
        if self.bias is not None:
            y = y + self.bias[None].to(y.dtype)
        return y

    def transform(self, x: torch.Tensor, output_shape=None) -> torch.Tensor:
        """The skip branch's resolution: the identity (no scaling)."""
        return x


class DistributedSpectralConv2d(_DistributedSpectralConv):
    """A ``conv_module`` for the FNO running :func:`distributed_spectral_conv2d`
    at model size > 1 (``FNO(..., conv_module=DistributedSpectralConv2d)``)."""

    n_dim = 2

    def _sharded(self, x, mesh):
        return distributed_spectral_conv2d(x, (self.w_weight[0], self.w_weight[1]),
                                           self.kept_modes, mesh)


class DistributedSpectralConv3d(_DistributedSpectralConv):
    """The 3-D counterpart: :func:`distributed_spectral_conv3d` at model size > 1."""

    n_dim = 3

    def _sharded(self, x, mesh):
        return distributed_spectral_conv3d(x, (self.w_weight[0], self.w_weight[1]),
                                           self.kept_modes, mesh)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        from_left, from_right = _ring_swap(x[:, :, -halo:], x[:, :, :halo], group)
        return torch.cat([from_left, x, from_right], dim=2)

    @staticmethod
    def backward(ctx, g):
        halo = ctx.halo
        # the halos' gradients go back to the ranks whose edges they were
        left, right = _ring_swap(g[:, :, :halo], g[:, :, -halo:], ctx.group, reverse=True)
        gx = g[:, :, halo:-halo].clone()
        gx[:, :, :halo] += left
        gx[:, :, -halo:] += right
        return gx, None, None


def _ring_swap(forward_part, backward_part, group, reverse: bool = False):
    """Send ``forward_part`` to the next rank of the ring and ``backward_part``
    to the previous one (the other way round with ``reverse``); return
    (what came from the previous rank, what came from the next)."""
    n = dist.get_world_size(group)
    if n == 1:
        return (backward_part.clone(), forward_part.clone()) if reverse else \
            (forward_part.clone(), backward_part.clone())
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prev = dist.get_global_rank(group, (r - 1) % n)
    if reverse:
        nxt, prev = prev, nxt
    forward_part, backward_part = forward_part.contiguous(), backward_part.contiguous()
    from_prev, from_next = torch.empty_like(forward_part), torch.empty_like(backward_part)
    ops = [dist.P2POp(dist.isend, forward_part, nxt, group),
           dist.P2POp(dist.irecv, from_prev, prev, group),
           dist.P2POp(dist.isend, backward_part, prev, group),
           dist.P2POp(dist.irecv, from_next, nxt, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return (from_next, from_prev) if reverse else (from_prev, from_next)


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """This rank's slab ``x`` (b, c, h_local, ...) padded along axis 2 with
    ``halo`` rows from each ring neighbour of ``group`` (the current mesh's
    model group by default): the previous rank's last rows before it, the
    next rank's first rows after it (a circular domain)."""
    group = group if group is not None else comm.get_model_parallel_group()
    if group is None:
        group = dist.group.WORLD
    return _Halo.apply(x, halo, group)


__all__ = ["DistributedSpectralConv2d", "DistributedSpectralConv3d", "all_to_all",
           "distributed_spectral_conv2d", "distributed_spectral_conv3d", "halo_exchange",
           "pad_to_multiple"]
