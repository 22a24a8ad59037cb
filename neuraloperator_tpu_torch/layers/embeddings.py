"""Positional embeddings (port of ``neuraloperator_tpu/layers/embeddings.py``):
the coordinate grids (``GridEmbeddingND``, ``GridEmbedding2D``,
``regular_grid_nd``, ``regular_grid_2d``), the sinusoidal embedding of point
coordinates (``SinusoidalEmbedding``) and the rotary one
(``RotaryEmbedding2D``, ``apply_rotary_pos_emb``)."""

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def regular_grid_nd(
    resolutions: Sequence[int],
    grid_boundaries: Sequence[Sequence[float]],
    device="cpu",
) -> List[torch.Tensor]:
    """Meshgrid of normalized coordinates, one tensor per dim."""
    if len(resolutions) != len(grid_boundaries):
        raise ValueError(
            f"{len(resolutions)} resolutions but {len(grid_boundaries)} boundaries"
        )
    axes = [
        np.linspace(lo, hi, n + 1)[:-1].astype(np.float32)
        for n, (lo, hi) in zip(resolutions, grid_boundaries)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return [torch.from_numpy(g).to(device) for g in grids]


def regular_grid_2d(spatial_dims: Sequence[int],
                    grid_boundaries=((0.0, 1.0), (0.0, 1.0)), device="cpu"):
    """The two coordinate grids of a 2-D domain."""
    gx, gy = regular_grid_nd(spatial_dims, grid_boundaries, device)
    return gx, gy


@functools.lru_cache(maxsize=32)
def _grid_channels(
    resolutions: Tuple[int, ...],
    boundaries: Tuple[Tuple[float, float], ...],
    device: torch.device,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The grid as one (1, dim, d1..dN) tensor, built once per device and
    outside inference mode, so that serving and training can share it."""
    with torch.inference_mode(False):
        grids = regular_grid_nd(resolutions, boundaries, device)
        return torch.stack(grids)[None].to(dtype)


class GridEmbeddingND:
    """Append N normalized coordinate channels to (b, c, d1..dN) inputs."""

    def __init__(self, in_channels: int, dim: int = 2, grid_boundaries=None):
        self.in_channels = in_channels
        self.dim = dim
        if grid_boundaries is None:
            grid_boundaries = [[0.0, 1.0]] * dim
        if len(grid_boundaries) != dim:
            raise ValueError(f"{len(grid_boundaries)} grid boundaries for {dim} dims")
        self.grid_boundaries = grid_boundaries

    @property
    def out_channels(self) -> int:
        return self.in_channels + self.dim

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        grid = _grid_channels(
            tuple(data.shape[2:]),
            tuple(tuple(float(v) for v in b) for b in self.grid_boundaries),
            data.device,
            data.dtype,
        )
        return torch.cat([data, grid.expand(data.shape[0], -1, *grid.shape[2:])], dim=1)


class GridEmbedding2D(GridEmbeddingND):
    """The 2-D grid embedding."""

    def __init__(self, in_channels: int, grid_boundaries=((0, 1), (0, 1))):
        super().__init__(in_channels, dim=2, grid_boundaries=list(grid_boundaries))


class SinusoidalEmbedding:
    """(..., in_channels) coordinates -> (..., in_channels * num_frequencies * 2).

    Each coordinate times each frequency gives an angle, embedded as (sin,
    cos), flattened coordinate-major: (c, f, 2). ``"transformer"`` uses the
    frequencies ``1 / max_positions ** (k / num_frequencies)``, ``"nerf"``
    ``2 ** k * pi``, k = 0 .. num_frequencies - 1, in float32. Takes (n, c)
    or (b, n, c) inputs.
    """

    def __init__(self, in_channels: int, num_frequencies: Optional[int] = None,
                 embedding_type: str = "transformer", max_positions: int = 10000):
        self.in_channels = in_channels
        self.num_frequencies = num_frequencies
        self.embedding_type = embedding_type
        self.max_positions = max_positions

    @property
    def out_channels(self) -> int:
        return 2 * self.in_channels * (self.num_frequencies or 1)

    def frequencies(self, device) -> torch.Tensor:
        k = torch.arange(self.num_frequencies, device=device)
        if self.embedding_type == "nerf":
            return (2.0 ** k) * math.pi
        if self.embedding_type == "transformer":
            return 1.0 / (self.max_positions ** (2 * k / (2 * self.num_frequencies)))
        raise ValueError(
            f"embedding_type must be 'transformer' or 'nerf', got {self.embedding_type}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        unbatched = x.ndim == 2
        if unbatched:
            x = x[None]
        b, n, _ = x.shape
        ang = x[..., None] * self.frequencies(x.device)
        emb = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(b, n, -1)
        return emb[0] if unbatched else emb


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairs (x1, x2) of the last axis -> (-x2, x1)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).reshape(*x.shape[:-2], -1)


class RotaryEmbedding2D:
    """Rotary position frequencies for attention-kernel layers:
    ``coordinates / min_freq * scale`` times the inverse frequencies
    ``1 / 10000 ** (2j / dim)``, repeated twice along the last axis."""

    def __init__(self, dim: int, min_freq: float = 1.0 / 64.0, scale: float = 1.0):
        self.dim = dim
        self.min_freq = min_freq
        self.scale = scale
        self.inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2).astype(np.float32) / dim))

    def __call__(self, coordinates: torch.Tensor) -> torch.Tensor:
        t = coordinates / self.min_freq * self.scale
        inv = torch.from_numpy(self.inv_freq).to(t.device)
        freqs = torch.einsum("...i,j->...ij", t, inv)
        return torch.cat([freqs, freqs], dim=-1)

    @staticmethod
    def apply_1d_rotary_pos_emb(t, freqs):
        return apply_rotary_pos_emb(t, freqs)

    @staticmethod
    def apply_2d_rotary_pos_emb(t, freqs_x, freqs_y):
        d = t.shape[-1]
        t_x, t_y = t[..., : d // 2], t[..., d // 2:]
        return torch.cat([apply_rotary_pos_emb(t_x, freqs_x),
                          apply_rotary_pos_emb(t_y, freqs_y)], dim=-1)


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate features ``t`` by the position frequencies ``freqs``."""
    return t * torch.cos(freqs) + rotate_half(t) * torch.sin(freqs)
