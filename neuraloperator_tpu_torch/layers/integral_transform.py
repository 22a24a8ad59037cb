"""Kernel integral transform over neighbourhoods, the GNO's core (port of
``neuraloperator_tpu/layers/integral_transform.py``).

For each output point x it integrates a learned kernel k(x, y[, f(y)]) over
the neighbours y of x, times f(y) for the ``linear`` and ``nonlinear``
types, and times mollifier weights when the neighbourhoods carry norms.
Neighbourhoods come padded (``neighbors_index`` (m, k), ``neighbors_mask``
(m, k)); a CSR dict is padded first. The neighbours' and the queries'
features are gathered into (m, k, ·), the kernel MLP runs over them as
plain matmuls and the masked sum or mean reduces over k.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .channel_mlp import LinearChannelMLP, gelu
from .segment_csr import masked_segment_reduce

_TRANSFORM_TYPES = ("linear_kernelonly", "linear", "nonlinear_kernelonly", "nonlinear")


class IntegralTransform(nn.Module):
    """``forward(y, neighbors, x=None, f_y=None, weights=None)``: y (n, d1)
    points, x (m, d2) queries (y when None), f_y (n, d3) or (b, n, d3)
    features; returns (m, d4) or (b, m, d4). The kernel MLP is
    ``channel_mlp``, a :class:`LinearChannelMLP` of ``channel_mlp_layers``."""

    def __init__(
        self,
        channel_mlp_layers: Sequence[int],
        channel_mlp_non_linearity: Callable = gelu,
        transform_type: str = "linear",
        weighting_fn: Optional[Callable] = None,
        reduction: str = "sum",
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if transform_type not in _TRANSFORM_TYPES:
            raise ValueError(
                f"transform_type={transform_type}, expected one of {_TRANSFORM_TYPES}")
        self.transform_type = transform_type
        self.weighting_fn = weighting_fn
        self.reduction = reduction
        self.channel_mlp = LinearChannelMLP(list(channel_mlp_layers),
                                            non_linearity=channel_mlp_non_linearity,
                                            device=device, generator=generator)

    def forward(self, y, neighbors, x=None, f_y=None, weights=None):
        if "neighbors_row_splits" in neighbors:
            from .neighbor_search import csr_to_padded

            neighbors = {k: v.to(y.device) for k, v in csr_to_padded(neighbors).items()}
        if x is None:
            x = y
        idx = neighbors["neighbors_index"]
        mask = neighbors["neighbors_mask"]
        m, k = idx.shape

        rep_features = y[idx]  # (m, k, d1)
        self_features = x[:, None, :].expand(m, k, x.shape[-1])
        agg = torch.cat([rep_features, self_features], dim=-1)

        batched = f_y is not None and f_y.ndim == 3
        in_features = None
        if f_y is not None:
            in_features = f_y[:, idx, :] if batched else f_y[idx]

        if f_y is not None and self.transform_type in ("nonlinear_kernelonly", "nonlinear"):
            if batched:
                agg = agg[None].expand(f_y.shape[0], *agg.shape)
            agg = torch.cat([agg, in_features], dim=-1)

        kernel = self.channel_mlp(agg)  # (..., m, k, d4)
        if f_y is not None and self.transform_type != "nonlinear_kernelonly":
            kernel = kernel * in_features

        reduction = self.reduction
        nbr_weights = neighbors.get("neighbors_norm")
        if nbr_weights is None:
            nbr_weights = weights
        if nbr_weights is None and self.weighting_fn is not None:
            raise KeyError("a weighting function requires neighborhoods with norms/weights")
        if nbr_weights is not None:
            w = nbr_weights
            if self.weighting_fn is not None:
                w = self.weighting_fn(w)
            kernel = kernel * w[..., None]
            reduction = "sum"
        return masked_segment_reduce(kernel, mask, reduction=reduction)
