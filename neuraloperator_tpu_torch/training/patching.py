"""Multigrid domain-decomposition patching, MG-TFNO (port of
``neuraloperator_tpu/training/patching.py``).

(b, c, h, w) inputs are split into 2^levels x 2^levels circularly padded
patches stacked on the batch dim, with coarser subsampled views of the
whole field concatenated as extra channels; the model's outputs are
unpadded and stitched back together. Every step is a pad, a slice, a stack
or a reshape of tensors whose shapes the host knows, so the patched train
step is captured in the staged CUDA graph like the plain one.

The JAX package shards the patch-stacked batch over a mesh's "model" axis
(``use_distributed``, ``mesh``); the port refuses both (ROADMAP
"distribution").
"""

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .._common import not_ported


def _wrap_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """``jnp.pad(mode="wrap")`` of the last ``len(pads)`` dims, each by
    ``pads[k]`` on both sides (every pad at most the dim it pads)."""
    flat = []
    for p in reversed(pads):
        flat += [p, p]
    return F.pad(x, flat, mode="circular")


def make_patches(x: torch.Tensor, n, p=0) -> torch.Tensor:
    """Split into n x n circularly padded patches stacked on the batch dim.

    (b, c, h, w) -> (b * n1 * n2, c, h/n1 + 2 p1, w/n2 + 2 p2); patch order
    is row-major within each batch element (i over height, j over width).
    1-D inputs (b, c, s) are also supported.
    """
    if isinstance(p, int):
        p = [p, p]
    if isinstance(n, int):
        n = [n, n]
    d = x.ndim - 2
    if d not in (1, 2):
        raise ValueError("only 1-D and 2-D patching supported")

    if d == 1:
        b, c, s = x.shape
        if n[-1] <= 1:
            return _wrap_pad(x, [p[-1]]) if p[-1] > 0 else x
        if s % n[-1]:
            raise ValueError(f"size {s} does not split into {n[-1]} patches")
        ps = s // n[-1]
        xp = _wrap_pad(x, [p[-1]])
        parts = [xp[:, :, j * ps: j * ps + ps + 2 * p[-1]] for j in range(n[-1])]
        return torch.stack(parts, dim=1).reshape(b * n[-1], c, ps + 2 * p[-1])

    b, c, h, w = x.shape
    if n[0] <= 1 and n[1] <= 1:
        if p[0] > 0 or p[1] > 0:
            return _wrap_pad(x, [p[0], p[1]])
        return x
    if h % n[0] or w % n[1]:
        raise ValueError(f"{h}x{w} does not split into {n[0]}x{n[1]} patches")
    ph, pw = h // n[0], w // n[1]
    xp = _wrap_pad(x, [p[0], p[1]])
    rows = [
        xp[:, :, i * ph: i * ph + ph + 2 * p[0], j * pw: j * pw + pw + 2 * p[1]]
        for i in range(n[0])
        for j in range(n[1])
    ]
    stacked = torch.stack(rows, dim=1)  # (b, n1*n2, c, hp, wp)
    return stacked.reshape(b * n[0] * n[1], c, ph + 2 * p[0], pw + 2 * p[1])


class MultigridPatching2D:
    """Patch before the model, unpatch and stitch after it.

    ``padding_height`` and ``padding_width`` are set by each
    ``_make_mg_patches`` call from the input it patches and read back by
    ``unpatch``: an evaluation at another resolution changes them between
    calls, as in the JAX package.
    """

    def __init__(
        self,
        *,
        levels: int = 0,
        padding_fraction: Union[float, Tuple[float, float]] = 0,
        use_distributed: bool = False,
        stitching: bool = True,
        mesh=None,
    ):
        if use_distributed or mesh is not None:
            raise not_ported("MultigridPatching2D use_distributed/mesh", "distribution")
        self.levels = levels
        if isinstance(padding_fraction, (int, float)):
            padding_fraction = [padding_fraction, padding_fraction]
        self.padding_fraction = list(padding_fraction)
        self.n_patches = [2 ** levels, 2 ** levels]
        self.stitching = stitching
        self.padding_height = 0
        self.padding_width = 0

    def patch(self, x: torch.Tensor, y: torch.Tensor):
        if not self.stitching:
            y = make_patches(y, n=self.n_patches[0], p=0)
        return self._make_mg_patches(x), y

    def unpatch(self, x: torch.Tensor, y: torch.Tensor, evaluation: bool = False):
        if self.padding_height > 0 or self.padding_width > 0:
            x = self._unpad(x)
        if self.stitching or evaluation:
            x = self._stitch(x)
        if evaluation and not self.stitching:
            y = self._stitch(y)
        return x, y

    def _stitch(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError("only 2-D stitching supported")
        n1, n2 = self.n_patches
        if n1 <= 1 and n2 <= 1:
            return x
        bp, c, hp, wp = x.shape
        b = bp // (n1 * n2)
        x = x.reshape(b, n1, n2, c, hp, wp).permute(0, 3, 1, 4, 2, 5)
        return x.reshape(b, c, n1 * hp, n2 * wp)

    def _make_mg_patches(self, x: torch.Tensor) -> torch.Tensor:
        levels = self.levels
        if levels <= 0:
            return x
        _, _, height, width = x.shape
        padding = [
            int(round(height * self.padding_fraction[0])),
            int(round(width * self.padding_fraction[1])),
        ]
        self.padding_height, self.padding_width = padding

        patched = make_patches(x, n=2 ** levels, p=padding)
        s1 = patched.shape[-2] - 2 * padding[0]
        s2 = patched.shape[-1] - 2 * padding[1]

        n = 2 ** levels
        for level in range(1, levels + 1):
            sub = 2 ** level
            s1_stride = s1 // sub
            s2_stride = s2 // sub
            x_sub = x[:, :, ::sub, ::sub]
            s2_pad = math.ceil((s2 + (n - 1) * s2_stride - x_sub.shape[-1]) / 2) + padding[1]
            s1_pad = math.ceil((s1 + (n - 1) * s1_stride - x_sub.shape[-2]) / 2) + padding[0]
            x_sub = _circular_pad(x_sub, s1_pad, s2_pad)
            # one coarse window per patch, in make_patches' order
            windows = [
                x_sub[:, :,
                      i * s1_stride: i * s1_stride + s1 + 2 * padding[0],
                      j * s2_stride: j * s2_stride + s2 + 2 * padding[1]]
                for i in range(n)
                for j in range(n)
            ]
            coarse = torch.stack(windows, dim=1).reshape(
                patched.shape[0], x.shape[1], s1 + 2 * padding[0], s2 + 2 * padding[1])
            patched = torch.cat([patched, coarse], dim=1)
        return patched

    def _unpad(self, x: torch.Tensor) -> torch.Tensor:
        return x[
            ...,
            self.padding_height: x.shape[-2] - self.padding_height,
            self.padding_width: x.shape[-1] - self.padding_width,
        ]


def _circular_pad(x: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """Circular pad of the last two dims by ``p1`` and ``p2`` on each side,
    in steps no wider than the dim (torch refuses a wider circular pad)."""
    while p2 > 0:
        step = min(p2, x.shape[-1])
        x = F.pad(x, (step, step, 0, 0), mode="circular")
        p2 -= step
    while p1 > 0:
        step = min(p1, x.shape[-2])
        x = F.pad(x, (0, 0, step, step), mode="circular")
        p1 -= step
    return x


__all__ = ["MultigridPatching2D", "make_patches"]
