"""Complex-valued activations and modules (port of
``neuraloperator_tpu/layers/complex.py``).

Split activations apply a real function to the real and the imaginary
parts; ``ComplexValued`` lifts a real module to complex inputs with two
independent copies, ``(fr(Re) - fi(Im)) + i (fr(Im) + fi(Re))``.
"""

from typing import Callable

import torch
from torch import nn


def _split_apply(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    return torch.complex(fn(x.real), fn(x.imag))


def CGELU(x: torch.Tensor) -> torch.Tensor:
    """Complex GELU: exact GELU on the real and imaginary parts."""
    return _split_apply(lambda v: nn.functional.gelu(v, approximate="none"), x)


def ctanh(x: torch.Tensor) -> torch.Tensor:
    """tanh on the real and imaginary parts."""
    return _split_apply(torch.tanh, x)


def cselu(x: torch.Tensor) -> torch.Tensor:
    """SELU on the real and imaginary parts."""
    return _split_apply(nn.functional.selu, x)


class ComplexValued(nn.Module):
    """Two copies of ``module_factory()`` acting as one complex-linear map.

    The copies are named as flax names the JAX module's unnamed children,
    ``{Class}_0`` (the real part's) and ``{Class}_1``, so the parameters
    keep the JAX package's paths.
    """

    def __init__(self, module_factory: Callable[[], nn.Module]):
        super().__init__()
        fr, fi = module_factory(), module_factory()
        self.names = (f"{type(fr).__name__}_0", f"{type(fi).__name__}_1")
        self.add_module(self.names[0], fr)
        self.add_module(self.names[1], fi)

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        fr, fi = (getattr(self, n) for n in self.names)
        real = fr(x.real, *args, **kwargs) - fi(x.imag, *args, **kwargs)
        imag = fr(x.imag, *args, **kwargs) + fi(x.real, *args, **kwargs)
        return torch.complex(real, imag)
