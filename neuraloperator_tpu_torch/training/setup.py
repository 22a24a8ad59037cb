"""Runtime setup: seeds and the matmul precision (port of
``neuraloperator_tpu/training/setup.py``).

The JAX package sets XLA's default matmul precision to ``"tensorfloat32"``
(three bf16 passes, about TF32's accuracy). Its counterpart here would be
``torch.set_float32_matmul_precision("high")`` (TF32 on the tensor cores).
The port does not switch it on: the "full" path keeps f32-accurate
matmuls, as the JAX package's spectral layers ask for ``Precision.HIGH`` in
their DFTs whatever the default, and ``layers/spectral_convolution.py``
turns TF32 off for every spectral layer on the card.
"""

from typing import Optional

import torch

from .._common import not_ported


def setup(config=None, matmul_precision: str = "highest", seed: Optional[int] = None,
          model_parallel_size: Optional[int] = None) -> None:
    """Seed torch's default generator (which draws the weights of a model
    built without its own generator) and set the matmul precision.

    ``seed`` is taken from ``config.distributed.seed`` when ``config`` has
    that section. Only ``"highest"`` (full f32) is ported; the mesh of the
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
    if matmul_precision != "highest":
        raise not_ported(f"matmul_precision={matmul_precision!r}", "mixed/half precision")
    torch.set_float32_matmul_precision("highest")
    if seed is not None:
        torch.manual_seed(seed)
