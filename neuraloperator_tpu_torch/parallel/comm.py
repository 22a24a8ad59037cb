"""Accessors, model-parallel collectives and tensor helpers (port of
``neuraloperator_tpu/parallel/comm.py``).

* The accessors answer from the process groups of the current
  :class:`~.mesh.Mesh` (and ``torch.distributed``'s world); without them
  they read 1 for sizes and 0 for ranks, as the JAX accessors do without
  a mesh.
* The four collectives of the model-parallel region are
  ``torch.autograd.Function``\\ s, each with the backward that XLA derives
  for the JAX ones:

  - ``copy_to``: identity forward, all-reduce backward;
  - ``reduce_from``: all-reduce forward, identity backward;
  - ``scatter_to``: this rank's slice forward, all-gather backward;
  - ``gather_from``: all-gather forward, this rank's slice backward.

  ``group`` defaults to the current mesh's model group; with none (or a
  group of one) each is the identity.
* ``split_tensor_along_dim``, ``pad_helper``, ``truncate_helper`` and
  ``get_memory_format``.
"""

import os
from typing import List

import torch
import torch.distributed as dist

from .mesh import (  # noqa: F401  (comm.init is the JAX module's name too)
    DATA_AXIS,
    MODEL_AXIS,
    get_data_parallel_size,
    get_mesh,
    get_model_parallel_size,
    init,
)

# --------------------------------------------------------------------------- accessors


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    """The rank on this host (``LOCAL_RANK``, as ``torchrun`` sets it)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def get_global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_data_parallel_group():
    mesh = get_mesh()
    return mesh.data_group if mesh is not None else None


def get_model_parallel_group():
    mesh = get_mesh()
    return mesh.model_group if mesh is not None else None


def get_data_parallel_rank() -> int:
    mesh = get_mesh()
    return mesh.data_rank if mesh is not None else 0


def get_model_parallel_rank() -> int:
    mesh = get_mesh()
    return mesh.model_rank if mesh is not None else 0


# ------------------------------------------------------------------- collectives


class SharedGroup:
    """A process group (or a ``Mesh`` of them) held by reference: a copy of
    the module holding it shares it (a process group cannot be copied)."""

    __slots__ = ("group",)

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self


def _group(group):
    return group if group is not None else get_model_parallel_group()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather_into(whole: torch.Tensor, piece: torch.Tensor, dim: int, group) -> None:
    """Every rank's ``piece`` of ``group`` into ``whole`` along ``dim`` (each
    rank's piece its equal slice, in rank order), through one buffer of the
    pieces stacked."""
    n = dist.get_world_size(group)
    buf = piece.new_empty((n, *piece.shape))
    dist.all_gather(list(buf.unbind(0)), piece.contiguous(), group=group)
    whole.view(*whole.shape[:dim], n, piece.shape[dim], *whole.shape[dim + 1:]).copy_(
        buf.movedim(0, dim))


def own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim`` over ``group``."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {size} ranks")
    chunk = x.shape[dim] // size
    return x.narrow(dim, dist.get_rank(group) * chunk, chunk).contiguous()


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_along(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.dim, ctx.group), None, None


def copy_to_model_parallel_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward, all-reduce backward."""
    group = _group(group)
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from_model_parallel_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce forward, identity backward."""
    group = _group(group)
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def scatter_to_model_parallel_region(x: torch.Tensor, dim: int = -1,
                                     group=None) -> torch.Tensor:
    """This rank's slice of ``dim`` forward, all-gather backward."""
    group = _group(group)
    return x if _size(group) == 1 else _ScatterTo.apply(x, dim % x.ndim, group)


def gather_from_model_parallel_region(x: torch.Tensor, dim: int = -1,
                                      group=None) -> torch.Tensor:
    """All-gather forward, this rank's slice backward."""
    group = _group(group)
    return x if _size(group) == 1 else _GatherFrom.apply(x, dim % x.ndim, group)


def reduce_value(x: torch.Tensor, group, reduction: str = "sum") -> torch.Tensor:
    """``x`` summed over ``group`` (``"sum"``) or averaged (``"mean"``): the
    value over the whole batch of a loss reduced so over each rank's slice;
    ``x`` itself over a group of one."""
    if _size(group) == 1:
        return x
    out = all_reduce(x, group)
    return out / dist.get_world_size(group) if reduction == "mean" else out


@torch.no_grad()
def reduce_gradients(params: List[torch.Tensor], group, reduction: str = "sum") -> None:
    """Each parameter's ``.grad`` summed (or averaged) over ``group`` in
    place, in one all-reduce per dtype; a parameter without a gradient
    takes zeros first, as optax gives every leaf one. Over a group of one
    the gradients are left as they are."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    size = _size(group)
    if size == 1:
        return
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if reduction == "mean":
            flat /= size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# ---------------------------------------------------------------------- helpers


def get_memory_format(x: torch.Tensor) -> str:
    """``"channels_last"`` for a 4-D tensor laid out so (and not also
    contiguous), else ``"contiguous"``."""
    if x.ndim == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return "channels_last"
    return "contiguous"


def split_tensor_along_dim(x: torch.Tensor, dim: int, num_chunks: int) -> List[torch.Tensor]:
    """``num_chunks`` equal chunks of ``x`` along ``dim``."""
    if x.shape[dim] % num_chunks != 0:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible into "
                         f"{num_chunks} chunks")
    return list(torch.chunk(x, num_chunks, dim=dim))


def pad_helper(x: torch.Tensor, dim: int, new_size: int, mode: str = "zero") -> torch.Tensor:
    """``dim`` zero-padded at its end to ``new_size``; ``mode="conj"`` fills
    the tail with the reversed conjugates of the first interior entries (the
    Hermitian extension of an rfft half-spectrum)."""
    dim = dim % x.ndim
    n_pad = new_size - x.shape[dim]
    if n_pad < 0:
        raise ValueError("new_size smaller than current size")
    if n_pad == 0:
        return x
    out = torch.cat([x, x.new_zeros(x.shape[:dim] + (n_pad,) + x.shape[dim + 1:])], dim=dim)
    if mode == "conj":
        # the padded array's entries 1..n_pad, conjugated and reversed
        tail = torch.flip(torch.conj(out.narrow(dim, 1, n_pad)), dims=(dim,))
        out = torch.cat([x, tail.resolve_conj()], dim=dim)
    return out


def truncate_helper(x: torch.Tensor, dim: int, new_size: int) -> torch.Tensor:
    """The first ``new_size`` entries of ``dim``."""
    return x.narrow(dim % x.ndim, 0, min(new_size, x.shape[dim % x.ndim]))


__all__ = ["SharedGroup", "copy_to_model_parallel_region", "gather_from_model_parallel_region",
           "get_data_parallel_group", "get_data_parallel_rank", "get_data_parallel_size",
           "get_global_rank", "get_local_rank", "get_memory_format", "get_mesh",
           "get_model_parallel_group", "get_model_parallel_rank", "get_model_parallel_size",
           "get_world_size", "init", "pad_helper", "reduce_from_model_parallel_region",
           "reduce_gradients", "reduce_value",
           "scatter_to_model_parallel_region", "split_tensor_along_dim", "truncate_helper"]
