"""Local convolutions at the precision ``training.setup`` chose.

cuDNN rounds float32 convolutions through TF32 by default
(``torch.backends.cudnn.allow_tf32``), which ``setup`` does not govern: it
sets only the matmul precision. The finite-difference convolution subtracts
two nearly equal convolutions, where TF32's rounding would show at 1e-3.
So the convolutions here follow the matmul precision: full float32 under
"highest" (the port's default), TF32 under "high" (the JAX package's
"tensorfloat32"). cuDNN's switch is process-wide and read when a convolution
is issued, the backward's included, so it is set around the forward and
around the backward and restored after each, as
``ops/fourier.py::dft_matmul_precision`` does for the DFT matmuls. On the
CPU the switch has no effect.
"""

import contextlib

import torch

_CONVS = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
          3: torch.nn.functional.conv3d}


@contextlib.contextmanager
def conv_precision():
    """cuDNN's TF32 switch set from the float32 matmul precision, restored on exit."""
    flags = torch.backends.cudnn
    saved = flags.allow_tf32
    flags.allow_tf32 = torch.get_float32_matmul_precision() != "highest"
    try:
        yield
    finally:
        flags.allow_tf32 = saved


class _Conv(torch.autograd.Function):
    """A "VALID" convolution of stride 1, forward and backward inside
    :func:`conv_precision`."""

    @staticmethod
    def forward(ctx, x, w, groups: int):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with conv_precision():
            return _CONVS[w.ndim - 2](x, w, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n = w.ndim - 2
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with conv_precision():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1] * n, [0] * n, [1] * n, False, [0] * n, ctx.groups, mask)
        return dx, dw, None


def conv_nd(x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Cross-correlation of ``x`` (b, in, d1..dN) with ``w`` (out, in / groups,
    k1..kN), no padding, stride 1 (``lax.conv_general_dilated`` with
    "VALID"), N = 1, 2 or 3."""
    return _Conv.apply(x, w, groups)
