"""Parameter initialisers following the flax initialisers of the JAX package.

Weights are drawn on the CPU from an explicit ``torch.Generator`` and then
moved to the target device, so one seed gives the same weights on every
device. On the ``meta`` device nothing is drawn: only shapes exist.
"""

from typing import Optional, Sequence

import torch

from .._common import resolve_device

# stddev of a unit normal truncated to [-2, 2]; flax divides by it so that
# the truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


def _draw(shape, device, fill, dtype: torch.dtype = torch.float32) -> torch.nn.Parameter:
    """Drawn in float32, then stored as ``dtype``."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.nn.Parameter(torch.empty(shape, device="meta", dtype=dtype))
    t = torch.empty(shape)
    fill(t)
    return torch.nn.Parameter(t.to(device=device, dtype=dtype))


def lecun_normal(shape: Sequence[int], device, generator: Optional[torch.Generator]):
    """flax ``lecun_normal()``: truncated normal, variance 1 / fan_in.

    flax reads fan_in from axis -2 of the shape, so for the package's
    ``(out, in)`` matrices fan_in is ``shape[-2]``, the output width.
    """
    fan_in = shape[-2]
    for s in shape[:-2]:
        fan_in *= s
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD

    def fill(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)

    return _draw(tuple(shape), device, fill)


def normal(shape: Sequence[int], std: float, device,
           generator: Optional[torch.Generator], dtype: torch.dtype = torch.float32):
    """``std * N(0, 1)``, drawn in float32 and stored as ``dtype``."""
    return _draw(
        tuple(shape), device,
        lambda t: t.normal_(0.0, std, generator=generator), dtype,
    )


def constant(shape: Sequence[int], value: float, device):
    return _draw(tuple(shape), device, lambda t: t.fill_(value))
