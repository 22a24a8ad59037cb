"""Dataset-side multigrid patching (port of
``neuraloperator_tpu/data/transforms/patching_transforms.py``):
``MGPatchingTransform`` (a ``Transform`` over ``MultigridPatching2D``),
``RandomMGPatch`` (one random patch a sample) and ``MGPTensorDataset``.

``training.patching`` is imported where it is used: the training package
imports this package.
"""

import numpy as np
import torch

from ..datasets.tensor_dataset import TensorDataset
from .base_transforms import Transform


def _patcher(**kwargs):
    from ...training.patching import MultigridPatching2D

    return MultigridPatching2D(**kwargs)


class MGPatchingTransform(Transform):
    """Multigrid patches of a (b, c, h, w) tensor, and their stitch."""

    def __init__(self, levels: int = 1, padding_fraction: float = 0,
                 stitching: bool = False):
        self.patcher = _patcher(levels=levels, padding_fraction=padding_fraction,
                                stitching=stitching)

    def transform(self, x):
        return self.patcher._make_mg_patches(x)

    def inverse_transform(self, x):
        return self.patcher._stitch(x)


class RandomMGPatch(Transform):
    """One patch of a sample ``(x, y)`` of numpy arrays (c, h, w), with its
    coarse context channels, drawn from ``np.random.RandomState(seed)``: the
    JAX transform's patch for the same seed."""

    def __init__(self, levels: int = 1, seed: int = 0):
        self.levels = levels
        self._rng = np.random.RandomState(seed)
        self.patcher = _patcher(levels=levels, padding_fraction=0)

    def transform(self, sample):
        from ...training.patching import make_patches

        x, y = sample
        px = self.patcher._make_mg_patches(torch.as_tensor(np.asarray(x))[None])
        py = make_patches(torch.as_tensor(np.asarray(y))[None], n=2 ** self.levels, p=0)
        i = int(self._rng.randint(px.shape[0]))
        return px[i].numpy(), py[i].numpy()

    def inverse_transform(self, sample):
        raise NotImplementedError("random patch selection is not invertible")


class MGPTensorDataset(TensorDataset):
    """A ``TensorDataset`` whose samples are random multigrid patches."""

    def __init__(self, x, y, levels: int = 1, seed: int = 0):
        super().__init__(x, y)
        self.transform = RandomMGPatch(levels=levels, seed=seed)

    def __getitem__(self, i):
        px, py = self.transform.transform((self.arrays["x"][i], self.arrays["y"][i]))
        return {"x": px, "y": py}
