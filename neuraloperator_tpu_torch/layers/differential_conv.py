"""Finite-difference convolution (port of
``neuraloperator_tpu/layers/differential_conv.py``).

A local convolution minus its response to the summed stencil (a zero-mean
stencil), divided by the grid width: it converges to a directional
derivative as the grid is refined. The convolutions are cuDNN's
(``ops/convolution.py``), at the precision ``training.setup`` chose.
"""

from typing import Optional

import torch
from torch import nn

from ..ops.convolution import conv_nd
from . import _init

# the JAX package's padding modes -> F.pad's
_PAD_MODES = {"periodic": "circular", "replicate": "replicate", "reflect": "reflect",
              "zeros": "constant"}


def pad_spatial(x: torch.Tensor, pad: int, n_dim: int, mode: str) -> torch.Tensor:
    """``pad`` points on both sides of each of the last ``n_dim`` axes:
    "periodic" (wrap), "replicate" (edge), "reflect" or "zeros"."""
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"padding mode {mode!r} not supported")
    return nn.functional.pad(x, [pad, pad] * n_dim, mode=_PAD_MODES[mode])


class FiniteDifferenceConvolution(nn.Module):
    """``forward(x, grid_width)``: (b, in, d1..dN) -> (b, out, d1..dN), N = 1, 2 or 3.

    ``kernel`` is (out, in / groups, k, ..., k), flax ``lecun_normal`` on
    that shape, as the JAX module names and draws it.
    """

    def __init__(self, in_channels: int, out_channels: int, n_dim: int, kernel_size: int = 3,
                 groups: int = 1, padding: str = "periodic", *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel size must be odd")
        if n_dim not in (1, 2, 3):
            raise NotImplementedError("differential convs not implemented for dims > 3")
        self.n_dim, self.kernel_size, self.groups, self.padding = (
            n_dim, kernel_size, groups, padding)
        self.kernel = _init.lecun_normal(
            (out_channels, in_channels // groups) + (kernel_size,) * n_dim, device, generator)

    def forward(self, x: torch.Tensor, grid_width: float) -> torch.Tensor:
        w = self.kernel
        xp = pad_spatial(x, self.kernel_size // 2, self.n_dim, self.padding)
        conv = conv_nd(xp, w, self.groups)
        # subtract the kernel-sum response: the convolution with the summed stencil
        w_sum = w.sum(dim=tuple(range(2, 2 + self.n_dim)), keepdim=True)
        return (conv - conv_nd(x, w_sum, self.groups)) / grid_width
