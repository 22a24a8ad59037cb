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

With a model-parallel size (``config.distributed.use_distributed``), it
also joins ``torch.distributed`` and returns the mesh (``parallel/mesh.py``).
"""

from typing import Optional

import torch

from .._common import Device
from ..parallel import mesh as mesh_lib

# the JAX package's names for XLA's default matmul precision -> torch's
_MATMUL_PRECISIONS = {"highest": "highest", "tensorfloat32": "high"}


def setup(config=None, matmul_precision: str = "highest", seed: Optional[int] = None,
          model_parallel_size: Optional[int] = None, device: Device = "cuda"):
    """Seed torch's default generator (which draws the weights of a model
    built without its own generator), set the matmul precision and, when
    asked, the mesh.

    ``seed`` is taken from ``config.distributed.seed`` when ``config`` has
    that section, and ``model_parallel_size`` from it with
    ``use_distributed``. With a ``model_parallel_size``, this process joins
    ``torch.distributed`` (``mesh.init_process_group``: ``torchrun``'s
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, or a world of one on a
    local store; NCCL for a CUDA ``device``, gloo for the CPU) and the
    ('data', 'model') mesh is built and returned (``mesh.init``); else
    None, as the JAX ``setup``. ``matmul_precision`` is ``"highest"`` (full
    f32) or ``"tensorfloat32"`` (TF32, the JAX package's default).
    """
    dist = getattr(config, "distributed", None)
    if dist is not None:
        if getattr(dist, "use_distributed", False):
            model_parallel_size = dist.model_parallel_size
        seed = getattr(dist, "seed", seed)
    if matmul_precision not in _MATMUL_PRECISIONS:
        raise ValueError(f"unknown matmul_precision {matmul_precision!r}; one of "
                         f"{sorted(_MATMUL_PRECISIONS)}")
    torch.set_float32_matmul_precision(_MATMUL_PRECISIONS[matmul_precision])
    if seed is not None:
        torch.manual_seed(seed)
    if model_parallel_size is None:
        return None
    return mesh_lib.init(model_parallel_size=model_parallel_size, device=device)
