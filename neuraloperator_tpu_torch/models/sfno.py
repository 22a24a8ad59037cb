"""Spherical Fourier Neural Operator (port of ``neuraloperator_tpu/models/sfno.py``).

The FNO with ``conv_module=SphericalConv`` and dense weights by default:
each Fourier layer's spectral convolution is a spherical harmonic transform,
a per-degree channel contraction and its inverse (``layers/spherical_convolution.py``).
"""

import inspect

from ..layers.spherical_convolution import SphericalConv
from .base_model import register_model
from .fno import FNO

_SFNO_DEFAULTS = {"factorization": "dense", "conv_module": SphericalConv}
# the FNO's arguments with the SFNO's defaults: what the registry records
_SFNO_SIGNATURE = inspect.signature(FNO.__init__).replace(parameters=[
    p.replace(default=_SFNO_DEFAULTS[name]) if name in _SFNO_DEFAULTS else p
    for name, p in inspect.signature(FNO.__init__).parameters.items()
])


@register_model(name="SFNO")
class SFNO(FNO):
    """FNO over the sphere: ``factorization="dense"`` and
    ``conv_module=SphericalConv`` by default, the FNO's arguments otherwise
    (the JAX ``SFNO``)."""

    def __init__(self, *args, **kwargs):
        bound = _SFNO_SIGNATURE.bind(self, *args, **kwargs)
        bound.apply_defaults()
        del bound.arguments["self"]
        super().__init__(**bound.arguments)

    __init__.__signature__ = _SFNO_SIGNATURE
