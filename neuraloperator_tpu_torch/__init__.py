"""PyTorch/CUDA port of ``neuraloperator_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``neuraloperator_tpu`` is the reference; this package
imports none of it. Ported so far: serving the FNO (``models.FNO``,
``serving.CompiledForward``) and its Tucker-factorized variant
(``models.TFNO``, ``tensor.factorized``) and training them (``training.Trainer``,
``training.build_optimizer``, ``losses``, ``data``), with the spectral mode
contraction and its backward as CUDA kernels (``ops/spectral_contraction.py``,
``csrc/spectral_contraction.cu``).
"""

__version__ = "0.1.0"
