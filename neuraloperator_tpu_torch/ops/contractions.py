"""Fourier-mode weight contraction (port of ``neuraloperator_tpu/ops/contractions.py``).

Only the dense, non-separable contraction is ported. Where the JAX
package chose between a Pallas kernel and a packed einsum by backend
(``set_contraction_backend``), the port goes by the tensor's device: CUDA
tensors take the CUDA kernels, CPU tensors their plain versions. On both
devices the contraction runs through ``ModeContraction``, so its backward
is the kernels' (K2 and K3) on the card and their plain versions on the CPU.
"""

from typing import Optional, Tuple

import torch

from .spectral_contraction import ModeContraction

Parts = Tuple[torch.Tensor, torch.Tensor]


def contract_dense(x: Parts, weight: Parts,
                   compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """x (re, im) of (b, i, m...), weight (re, im) of (i, o, m...) -> f32 (b, o, m...).

    ``compute_dtype`` (``torch.bfloat16`` under the "half" and "mixed"
    block precisions) is the dtype both operands are cast to first, so the
    kernels run their bf16 variants and sum in f32, as the JAX
    ``contract_dense`` casts them. The modes are flattened into one
    trailing axis, which keeps the natural layout: no operand is transposed.
    """
    xr, xi = x
    wr, wi = weight
    if compute_dtype is not None:
        xr, xi, wr, wi = (t.to(compute_dtype) for t in (xr, xi, wr, wi))
    b, i, *modes = xr.shape
    o = wr.shape[1]
    if tuple(wr.shape) != (i, o, *modes):
        raise ValueError(
            f"weight {tuple(wr.shape)} does not fit x {tuple(xr.shape)}"
        )
    flat_x = [t.reshape(b, i, -1).contiguous() for t in (xr, xi)]
    flat_w = [t.reshape(i, o, -1).contiguous() for t in (wr, wi)]
    out_r, out_i = ModeContraction.apply(*flat_x, *flat_w)
    return out_r.reshape(b, o, *modes), out_i.reshape(b, o, *modes)
