"""Fourier-mode weight contraction (port of ``neuraloperator_tpu/ops/contractions.py``).

Only the dense, non-separable contraction is ported. Where the JAX
package chose between a Pallas kernel and a packed einsum by backend
(``set_contraction_backend``), the port goes by the tensor's device: CUDA
tensors take the CUDA kernel, CPU tensors its plain version.
"""

from typing import Tuple

import torch

from .spectral_contraction import mode_contraction

Parts = Tuple[torch.Tensor, torch.Tensor]


def contract_dense(x: Parts, weight: Parts) -> Parts:
    """x (re, im) of (b, i, m...), weight (re, im) of (i, o, m...) -> f32 (b, o, m...).

    The modes are flattened into one trailing axis, which keeps the natural
    layout: no operand is transposed.
    """
    xr, xi = x
    wr, wi = weight
    b, i, *modes = xr.shape
    o = wr.shape[1]
    if tuple(wr.shape) != (i, o, *modes):
        raise ValueError(
            f"weight {tuple(wr.shape)} does not fit x {tuple(xr.shape)}"
        )
    flat_x = [t.reshape(b, i, -1).contiguous() for t in (xr, xi)]
    flat_w = [t.reshape(i, o, -1).contiguous() for t in (wr, wi)]
    out_r, out_i = mode_contraction(*flat_x, *flat_w)
    return out_r.reshape(b, o, *modes), out_i.reshape(b, o, *modes)
