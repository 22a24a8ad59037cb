"""The spectral convolution interface (port of
``neuraloperator_tpu/layers/base_spectral_conv.py``)."""

from torch import nn


class BaseSpectralConv(nn.Module):
    """Interface: subclasses implement ``forward(x, output_shape=None)``
    and ``transform(x, output_shape=None)``."""

    def transform(self, x, output_shape=None):
        raise NotImplementedError(
            "spectral conv modules must implement transform() to resample "
            "skip branches to the layer's output resolution"
        )
