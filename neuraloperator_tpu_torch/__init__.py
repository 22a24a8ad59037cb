"""PyTorch/CUDA port of ``neuraloperator_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``neuraloperator_tpu`` is the reference; this package
imports none of it. Ported so far: the FNO serving path (``models.FNO``,
``serving.CompiledForward``) with the spectral mode contraction as a CUDA
kernel (``ops/spectral_contraction.py``, ``csrc/spectral_contraction.cu``).
"""

__version__ = "0.1.0"
