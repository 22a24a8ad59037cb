"""Skip connections (port of ``neuraloperator_tpu/layers/skip_connections.py``)."""

from typing import Optional

import torch
from torch import nn

from ..ops.convolution import conv_nd
from . import _init


class SoftGating(nn.Module):
    """Per-channel learnable gate ``x * w (+ b)``, channels first."""

    def __init__(
        self,
        in_features: int,
        out_features: Optional[int] = None,
        n_dim: int = 2,
        use_bias: bool = False,
        *,
        device="cuda",
    ):
        super().__init__()
        if out_features is not None and in_features != out_features:
            raise ValueError(
                "SoftGating requires in_features == out_features, got "
                f"{in_features} != {out_features}"
            )
        shape = (1, in_features) + (1,) * n_dim
        self.weight = _init.constant(shape, 1.0, device)
        self.bias = _init.constant(shape, 1.0, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            return self.weight * x + self.bias
        return self.weight * x


class Flattened1dConv(nn.Module):
    """Pointwise channel projection over the flattened spatial dims, in the
    promoted dtype of the input and the weight (as the JAX einsum)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        use_bias: bool = False,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.weight = _init.lecun_normal((out_channels, in_channels), device, generator)
        self.bias = _init.constant((out_channels,), 0.0, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, *spatial = x.shape
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        y = torch.matmul(self.weight.to(dtype), x.reshape(b, c, -1).to(dtype))
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y.reshape(b, self.out_channels, *spatial)


class LocalConvSkip(nn.Module):
    """Local N-D convolution, kernel > 1, "SAME" padding (the
    ``conv_bias_kernel > 1`` option of the Fourier layers).

    ``kernel`` is (out, in, k, ..., k), flax ``lecun_normal`` on that shape,
    as the JAX module declares it. The padding is lax's "SAME": ``k - 1`` in
    all, ``(k - 1) // 2`` before and the rest after, so an even kernel puts
    its extra pad after, as ``lax.conv_general_dilated`` does. The
    convolution is a cross-correlation in the promoted dtype of the input
    and the kernel, at ``training.setup``'s precision (``ops/convolution.py``).
    """

    def __init__(self, in_channels: int, out_channels: int, n_dim: int, kernel_size: int, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_dim not in (1, 2, 3):
            raise ValueError(f"LocalConvSkip supports 1 to 3 spatial dims, got {n_dim}")
        self.n_dim, self.kernel_size = n_dim, kernel_size
        self.kernel = _init.lecun_normal(
            (out_channels, in_channels) + (kernel_size,) * n_dim, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo = (self.kernel_size - 1) // 2
        hi = self.kernel_size - 1 - lo
        dtype = torch.promote_types(x.dtype, self.kernel.dtype)
        x = nn.functional.pad(x.to(dtype), [lo, hi] * self.n_dim)
        return conv_nd(x, self.kernel.to(dtype))


def skip_connection(
    in_features: int,
    out_features: int,
    n_dim: int = 2,
    use_bias: bool = False,
    skip_type: str = "soft-gating",
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build the skip named by ``skip_type``."""
    st = skip_type.lower()
    if st == "soft-gating":
        return SoftGating(in_features, out_features, n_dim, use_bias, device=device)
    if st == "linear":
        return Flattened1dConv(
            in_features, out_features, use_bias, device=device, generator=generator
        )
    if st == "identity":
        return nn.Identity()
    raise ValueError(
        f"Got skip_type={skip_type}, expected one of 'soft-gating', 'linear', 'identity'"
    )
