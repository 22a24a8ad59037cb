"""Attention-based kernel integral, linear attention over point sets (port
of ``neuraloperator_tpu/layers/attention_kernel_integral.py``).

``k(x, y) = Σ_c q_c(x) k_c(y)``: the integral against ``v`` is, in the
associative order, one ``Kᵀ V`` contraction per head and a product with
``Q``, whatever the number of points. Self or cross attention, the keys and
values instance-normalized over the points, quadrature ``weights`` folded
into the values (``1 / n_src`` without), rotary positional embeddings on
queries and keys, and the projections initialized per head by xavier
uniform plus ``gain · I`` when a head's width equals the input's. The
parameters keep the flax names: ``wq``, ``wk``, ``wv`` (in, heads ·
head_channels) and ``to_out`` (a flax ``Dense``) when the heads' width is
not ``out_channels``. The products follow ``training.setup``'s matmul
precision, as JAX's follow its default.
"""

import math
from typing import Optional

import torch
from torch import nn

from .._common import resolve_device
from .normalization_layers import Dense


def _diag_xavier(n_heads: int, head_ch: int, in_ch: int, gain: float, device,
                 generator: Optional[torch.Generator]) -> nn.Parameter:
    """(in_ch, n_heads · head_ch): each head's block xavier uniform, plus
    ``gain · I`` when ``head_ch == in_ch``, drawn head by head on the CPU."""
    limit = gain * math.sqrt(6.0 / (in_ch + head_ch))
    cols = []
    for _ in range(n_heads):
        w = torch.empty(in_ch, head_ch).uniform_(-limit, limit, generator=generator)
        if head_ch == in_ch:
            w = w + gain * torch.eye(in_ch)
        cols.append(w)
    return nn.Parameter(torch.cat(cols, dim=1).to(device))


def _norm_domain(u: torch.Tensor) -> torch.Tensor:
    """Instance norm over the points (axis 2) per (batch, head, channel)."""
    mean = u.mean(dim=2, keepdim=True)
    var = u.var(dim=2, keepdim=True, unbiased=False)
    return (u - mean) * torch.rsqrt(var + 1e-5)


class AttentionKernelIntegral(nn.Module):
    """``forward(u_src (b, n, in), pos_src (b, n, d), positional_embedding_module=None,
    u_qry=None, pos_qry=None, weights=None, associative=True,
    return_kernel=False)`` -> (b, n_qry, out) (and the kernel matrix
    (b, heads, n_qry, n_src) with ``return_kernel``, which needs
    ``associative=False``)."""

    def __init__(self, in_channels: int, out_channels: int, n_heads: int, head_n_channels: int,
                 project_query: bool = True, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.n_heads, self.head_n_channels = n_heads, head_n_channels
        dim = n_heads * head_n_channels
        gain = 1.0 / math.sqrt(head_n_channels)

        def init():
            return _diag_xavier(n_heads, head_n_channels, in_channels, gain, device, generator)

        self.wq = init() if project_query else None
        self.wk = init()
        self.wv = init()
        self.to_out = (Dense(dim, out_channels, device=device, generator=generator)
                       if dim != out_channels else None)

    def _heads(self, z: torch.Tensor) -> torch.Tensor:
        b, n = z.shape[:2]
        return z.reshape(b, n, self.n_heads, self.head_n_channels).permute(0, 2, 1, 3)

    def forward(self, u_src, pos_src, positional_embedding_module=None, u_qry=None,
                pos_qry=None, weights=None, associative: bool = True,
                return_kernel: bool = False):
        if u_qry is None:
            if pos_qry is not None:
                raise ValueError("query coordinates given without a query function")
            u_qry = u_src
        elif pos_qry is None:
            raise ValueError("query function given without query coordinates")
        if return_kernel and associative:
            raise ValueError("kernel matrix unavailable with associative=True")
        b, n_src = u_src.shape[:2]
        n_qry = u_qry.shape[1]
        q = self._heads(u_qry @ self.wq if self.wq is not None else u_qry)
        k = _norm_domain(self._heads(u_src @ self.wk))
        v = _norm_domain(self._heads(u_src @ self.wv))

        pe = positional_embedding_module
        if pe is not None:
            pq = pos_src if pos_qry is None else pos_qry
            if pos_src.shape[-1] == 2:
                q = pe.apply_2d_rotary_pos_emb(q, pe(pq[..., 0])[:, None], pe(pq[..., 1])[:, None])
                k = pe.apply_2d_rotary_pos_emb(k, pe(pos_src[..., 0])[:, None],
                                               pe(pos_src[..., 1])[:, None])
            elif pos_src.shape[-1] == 1:
                q = pe.apply_1d_rotary_pos_emb(q, pe(pq[..., 0])[:, None])
                k = pe.apply_1d_rotary_pos_emb(k, pe(pos_src[..., 0])[:, None])
            else:
                raise ValueError("rotary embedding supports <= 2 dims")

        # the quadrature weights multiply the source points' contributions
        v = v * weights.reshape(b, 1, n_src, 1) if weights is not None else v / n_src
        kxy = None
        if associative:
            u = torch.einsum("bhmc,bhcd->bhmd", q, torch.einsum("bhnc,bhnd->bhcd", k, v))
        else:
            kxy = torch.einsum("bhmc,bhnc->bhmn", q, k)
            u = torch.einsum("bhmn,bhnd->bhmd", kxy, v)
        u = u.permute(0, 2, 1, 3).reshape(b, n_qry, self.n_heads * self.head_n_channels)
        if self.to_out is not None:
            u = self.to_out(u)
        return (u, kxy) if return_kernel else u
