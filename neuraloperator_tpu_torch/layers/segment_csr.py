"""Segment reductions (port of ``neuraloperator_tpu/layers/segment_csr.py``):
over CSR segments (``segment_csr``, ``index_add_`` where JAX has
``jax.ops.segment_sum``) and over the padded neighbour layout
(``masked_segment_reduce``, the one the GNO layers use)."""

from typing import Literal

import torch


def segment_csr(
    src: torch.Tensor,
    indptr: torch.Tensor,
    reduction: Literal["sum", "mean"] = "sum",
) -> torch.Tensor:
    """Reduce the rows of ``src`` (nnz, d) or (batch, nnz, d) into the
    segments ``indptr`` (m + 1,) delimits (a batched ``indptr`` uses its
    first row): (m, d) or (batch, m, d). Rows past ``indptr[-1]`` belong to
    no segment; ``"mean"`` divides by each segment's length, at least 1."""
    indptr = torch.as_tensor(indptr, device=src.device)
    while indptr.ndim > 1:
        indptr = indptr[0]
    n_segments = indptr.shape[0] - 1
    positions = torch.arange(src.shape[-2], device=src.device)
    seg_ids = torch.searchsorted(indptr[1:].contiguous(), positions, right=True)
    keep = seg_ids < n_segments
    out = src.new_zeros((*src.shape[:-2], n_segments, src.shape[-1]))
    out = out.index_add(src.ndim - 2, seg_ids[keep], src[..., keep, :])
    if reduction == "mean":
        counts = (indptr[1:] - indptr[:-1]).clamp(min=1).to(src.dtype)
        out = out / counts[:, None]
    return out


def masked_segment_reduce(
    values: torch.Tensor,
    mask: torch.Tensor,
    reduction: Literal["sum", "mean"] = "sum",
) -> torch.Tensor:
    """Padded reduction over the neighbour axis: ``values`` (..., m, k, d)
    and ``mask`` (m, k) give (..., m, d); ``"mean"`` divides by each row's
    count of set entries, at least 1."""
    mask_f = mask.to(values.dtype)[..., None]
    total = (values * mask_f).sum(dim=-2)
    if reduction == "mean":
        counts = mask.to(values.dtype).sum(dim=-1)[..., None]
        total = total / torch.clamp(counts, min=1.0)
    return total
