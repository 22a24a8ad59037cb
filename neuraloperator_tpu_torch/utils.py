"""Small shared utilities (port of ``neuraloperator_tpu/utils.py``):
parameter counts, the scaling-factor check, the radial energy spectrum,
ranks, the repository root and a FLOP count.

The JAX module's wandb helpers are not ported (``wandb`` is out of scope).
``count_flops`` counts with ``torch.utils.flop_counter.FlopCounterMode``
where the JAX function asks XLA's cost analysis.
"""

import math
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

Number = Union[int, float]


def count_tensor_params(tensor, dims=None) -> int:
    """Real parameters in ``tensor`` (over the listed ``dims`` only, when
    given); a complex entry counts twice."""
    shape = tensor.shape if dims is None else [tensor.shape[d] for d in dims]
    is_complex = tensor.is_complex() if torch.is_tensor(tensor) else np.iscomplexobj(tensor)
    return math.prod(shape) * (2 if is_complex else 1)


def count_model_params(model: torch.nn.Module) -> int:
    """Total real parameter count of ``model``; a complex entry counts twice,
    as in the JAX package."""
    return sum(count_tensor_params(p) for _, p in model.named_parameters())


def validate_scaling_factor(
    scaling_factor: Union[None, Number, List[Number], List[List[Number]]],
    n_dim: int,
    n_layers: Optional[int] = None,
) -> Union[None, List[float], List[List[float]]]:
    """Normalize a resolution scaling factor: a scalar is broadcast over dims
    (and layers); per-layer lists are checked for shape; anything else is
    None, as in the JAX package."""
    if scaling_factor is None:
        return None
    if isinstance(scaling_factor, (float, int)):
        if n_layers is None:
            return [float(scaling_factor)] * n_dim
        return [[float(scaling_factor)] * n_dim] * n_layers
    if isinstance(scaling_factor, (list, tuple)) and len(scaling_factor) > 0:
        if all(isinstance(s, (float, int)) for s in scaling_factor):
            if n_layers is None and len(scaling_factor) == n_dim:
                return [float(s) for s in scaling_factor]
            if n_layers is not None and len(scaling_factor) == n_layers:
                return [[float(s)] * n_dim for s in scaling_factor]
        if all(
            isinstance(s, (list, tuple))
            and len(s) == n_dim
            and all(isinstance(v, (float, int)) for v in s)
            for s in scaling_factor
        ):
            return [[float(v) for v in s] for s in scaling_factor]
    return None


def compute_explained_variance(frequency_max: int, s) -> float:
    """The share of ``sum(s**2)`` in the first ``frequency_max`` entries of
    ``s`` (a negative count drops that many from the end, as a slice does),
    in f32 as the JAX function computes it; the incremental FNO trainer's
    gradient criterion."""
    s = torch.as_tensor(s, dtype=torch.float32)
    total = torch.sum(s ** 2)
    return float(torch.sum(s[:frequency_max] ** 2) / total)


def spectrum_2d(signal, n_observations: int, normalize: bool = True) -> torch.Tensor:
    """Radial energy spectrum of a (T, s, s) signal (any shape of T * s * s
    entries): the squared modulus of its 2-D FFT (``rfft2`` when not
    ``normalize``), shifted, averaged over T and summed over the rings of
    integer radius 1..s/2; float64, as the JAX function's numpy sums."""
    signal = torch.as_tensor(signal)
    s = n_observations
    signal = signal.reshape(signal.shape[0], s, s)
    if normalize:
        spectrum = torch.fft.fft2(signal)
    else:
        spectrum = torch.fft.rfft2(signal, s=(s, s), norm="backward")
    spectrum = torch.fft.fftshift(spectrum, dim=(-2, -1))
    sq = (spectrum.real ** 2 + spectrum.imag ** 2).mean(dim=0).cpu().numpy()
    k_max = s // 2
    idx = np.indices((s, s)) - k_max
    radius = np.sqrt(idx[0] ** 2 + idx[1] ** 2).astype(np.int64)
    out = np.zeros(k_max)
    for k in range(1, k_max + 1):
        out[k - 1] = sq[radius == k].sum()
    return torch.from_numpy(out)


def compute_rank(tensor) -> torch.Tensor:
    """The matrix rank (``torch.linalg.matrix_rank``)."""
    return torch.linalg.matrix_rank(torch.as_tensor(tensor))


def compute_stable_rank(tensor) -> torch.Tensor:
    """The stable rank ``||A||_F^2 / ||A||_2^2`` of ``tensor`` flattened to
    (first dim, rest)."""
    a = torch.as_tensor(tensor)
    a = a.reshape(a.shape[0], -1)
    return torch.linalg.matrix_norm(a, "fro") ** 2 / torch.linalg.matrix_norm(a, 2) ** 2


def get_project_root() -> Path:
    """The repository's root directory (the one holding this package)."""
    return Path(__file__).parent.parent


def count_flops(fn, *args, **kwargs) -> dict:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and
    their backward, as torch's counter formulas count them; a complex
    matmul counted as its real ones where the call makes them real).
    ``{"flops": n, "bytes_accessed": nan}``: the JAX function's keys, the
    second not counted here."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan")}


__all__ = ["compute_explained_variance", "compute_rank", "compute_stable_rank",
           "count_flops", "count_model_params", "count_tensor_params", "get_project_root",
           "spectrum_2d", "validate_scaling_factor"]
