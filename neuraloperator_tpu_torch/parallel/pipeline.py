"""GPipe pipeline parallelism over the model group (port of
``neuraloperator_tpu/parallel/pipeline.py``).

Stage ``s`` of ``S`` (the model rank) holds ``n_layers / S`` consecutive
Fourier layers; ``M`` microbatches stream through the stages over
``M + S - 1`` ticks, each tick applying every rank's stage and shifting
the outputs one rank along the ring (``dist.batch_isend_irecv``). The JAX
package scans the ticks and lets AD transpose each ``ppermute``; here the
shift is an autograd ``Function`` whose backward is the shift the other
way round, so the backward runs the reversed schedule. Every rank keeps
every shift and the microbatches in its graph (each stage's input is its
own beside a zero multiple of the other, and the non-last stages' outputs
enter the result multiplied by zero), so all ranks run each backward
exchange.

As in JAX the microbatches and the result are the same on every model
rank: the input enters through ``copy_to_model_parallel_region`` and the
last stage's outputs leave through ``reduce_from_model_parallel_region``,
and each stage's slice of a stacked parameter is cut from the whole
parameter after a ``copy_to``, so every rank ends with the whole gradient.
"""

from typing import Callable

import torch
import torch.distributed as dist

from . import comm
from .mesh import MODEL_AXIS

__all__ = ["gpipe", "pipelined_fno_forward"]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent ``step`` ranks along the ring of ``group``; what arrives."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x.clone()
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def gpipe(stage_fn: Callable, stage_args, x_mb: torch.Tensor, *, n_stages: int,
          group=None) -> torch.Tensor:
    """Differentiable GPipe loop over ``group`` (the current mesh's model
    group by default): ``stage_fn(stage_args, x)`` applies this rank's stage
    to one microbatch, keeping its shape and dtype; ``x_mb`` (M, mb, ...)
    holds the microbatches, the same on every rank. Returns (M, mb, ...),
    the same on every rank."""
    group = group if group is not None else comm.get_model_parallel_group()
    if group is None or dist.get_world_size(group) != n_stages:
        raise ValueError(f"gpipe needs a model group of {n_stages} ranks")
    stage = dist.get_rank(group)
    x_mb = comm.copy_to_model_parallel_region(x_mb, group)
    n_mb = x_mb.shape[0]
    n_ticks = n_mb + n_stages - 1
    state = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(n_ticks):
        # stage 0 reads a fresh microbatch, the others what came along the
        # ring; each keeps the other input in its graph at weight 0, so that
        # every rank runs every backward exchange
        fresh = x_mb[min(t, n_mb - 1)]
        inp = fresh + 0 * state if stage == 0 else state + 0 * fresh
        out = stage_fn(stage_args, inp)
        outs.append(out)
        if t < n_ticks - 1:
            state = _RingShift.apply(out, group)
    # microbatch m leaves the last stage at tick m + S - 1
    y = torch.stack(outs[n_stages - 1:]) * (1.0 if stage == n_stages - 1 else 0.0)
    return comm.reduce_from_model_parallel_region(y, group)


def pipelined_fno_forward(model, x: torch.Tensor, mesh, *, n_microbatches: int,
                          model_axis: str = MODEL_AXIS) -> torch.Tensor:
    """Pipeline-parallel forward of an ``FNO(..., scan_layers=True)``: its
    Fourier layers as ``mesh.shape["model"]`` stages of consecutive layers,
    the embedding, lifting, padding and projection run on every rank. ``x``
    is this rank's batch (its data rank's slice); the batch must divide
    into ``n_microbatches``. The same numbers as ``model(x)``; the JAX
    function's ``params`` are the model's own here."""
    from ..layers.scan_fno_block import run_layer

    if not model.scan_layers:
        raise ValueError("pipelined_fno_forward requires FNO(..., scan_layers=True) "
                         "(stacked per-layer parameters)")
    n_stages = mesh.shape[model_axis]
    n_layers = model.n_layers
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by {n_stages} pipeline stages")
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by n_microbatches={n_microbatches}")
    group, stage = mesh.model_group, mesh.model_rank
    if model.embedding is not None:
        x = model.embedding(x)
    h = model.lifting(x)
    if model.domain_padding is not None:
        h = model.domain_padding.pad(h)
    blocks = model.fno_blocks
    names, stacked = zip(*blocks.layers.named_parameters())
    per_stage = n_layers // n_stages
    local = [comm.copy_to_model_parallel_region(p, group).narrow(0, stage * per_stage,
                                                                 per_stage)
             for p in stacked]

    def stage_fn(args, h):
        for j in range(per_stage):
            i = stage * per_stage + j
            h = run_layer(blocks.layers, {n: t[j] for n, t in zip(names, args)}, h,
                          (i < n_layers - 1,), blocks.remat)
        return h

    h_mb = h.reshape(n_microbatches, batch // n_microbatches, *h.shape[1:])
    y = gpipe(stage_fn, local, h_mb, n_stages=n_stages, group=group)
    y = y.reshape(batch, *y.shape[2:])
    if model.domain_padding is not None:
        y = model.domain_padding.unpad(y)
    return model.projection(y)
