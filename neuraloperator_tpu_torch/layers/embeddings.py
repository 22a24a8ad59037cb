"""Grid positional embeddings (port of ``GridEmbeddingND``,
``GridEmbedding2D``, ``regular_grid_nd`` and ``regular_grid_2d`` of
``neuraloperator_tpu/layers/embeddings.py``)."""

import functools
from typing import List, Sequence, Tuple

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
