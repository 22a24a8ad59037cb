"""Runtime setup: seeds and the matmul precision (port of
``neuraloperator_tpu/training/setup.py``).

The JAX package sets XLA's default matmul precision to ``"tensorfloat32"``
(three bf16 passes, about TF32's accuracy) unless told otherwise. Its
counterpart here, ``matmul_precision="tensorfloat32"``, is
``torch.set_float32_matmul_precision("high")`` (TF32 on the tensor cores).
The port's default stays ``"highest"`` (full f32), so every path keeps the
numerics it was checked at. Either way the spectral layers' DFT matmuls run
f32-accurate, as the JAX package asks for ``Precision.HIGH`` in them
whatever the default: ``ops/fourier.py::dft_matmul_precision`` switches TF32
off around each of them and restores the value set here. The local
convolutions (finite-difference, DISCO, the local skip) follow the matmul
precision set here, cuDNN's TF32 off under "highest"
(``ops/convolution.py``).
"""

from typing import Optional

import torch

from .._common import not_ported

# the JAX package's names for XLA's default matmul precision -> torch's
_MATMUL_PRECISIONS = {"highest": "highest", "tensorfloat32": "high"}


def setup(config=None, matmul_precision: str = "highest", seed: Optional[int] = None,
          model_parallel_size: Optional[int] = None) -> None:
    """Seed torch's default generator (which draws the weights of a model
    built without its own generator) and set the matmul precision.

    ``seed`` is taken from ``config.distributed.seed`` when ``config`` has
    that section. ``matmul_precision`` is ``"highest"`` (full f32) or
    ``"tensorfloat32"`` (TF32, the JAX package's default). The mesh of the
    JAX package's distributed setup raises. Returns None, as the JAX
    ``setup`` does without a mesh.
    """
    dist = getattr(config, "distributed", None)
    if dist is not None:
        if getattr(dist, "use_distributed", False):
            model_parallel_size = dist.model_parallel_size
        seed = getattr(dist, "seed", seed)
    if model_parallel_size is not None:
        raise not_ported("setup with a device mesh", "distribution")
    if matmul_precision not in _MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}; one of "
                         f"{sorted(_MATMUL_PRECISIONS)}")
    torch.set_float32_matmul_precision(_MATMUL_PRECISIONS[matmul_precision])
    if seed is not None:
        torch.manual_seed(seed)
