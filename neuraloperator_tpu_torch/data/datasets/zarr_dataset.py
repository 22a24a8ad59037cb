"""A dataset over a zarr store (port of
``neuraloperator_tpu/data/datasets/zarr_dataset.py``).

Map-style, read lazily sample by sample from a store holding ``x`` and
``y`` arrays on a 1024 grid, subsampled to ``resolution`` (128, 256, 512
or 1024), each field given a leading channel axis and passed through its
optional transform. ``zarr`` is an optional package: without it
``ZarrDataset`` raises an ``ImportError`` when it is made (the module
imports without it).
"""

from typing import Optional

import numpy as np

try:  # optional
    import zarr

    _HAS_ZARR = True
except ImportError:
    zarr = None
    _HAS_ZARR = False


class ZarrDataset:
    """``{'x', 'y'}`` samples of a zarr store, ``resolution`` mapped to a
    subsampling step of the stored 1024 grid."""

    _RESOLUTION_TO_STEP = {128: 8, 256: 4, 512: 2, 1024: 1}

    def __init__(self, filename, resolution: int = 128, transform_x=None, transform_y=None,
                 n_samples: Optional[int] = None):
        if not _HAS_ZARR:
            raise ImportError("ZarrDataset requires the optional dependency `zarr`, which "
                              "is not installed in this environment.")
        try:
            self.subsample_step = self._RESOLUTION_TO_STEP[resolution]
        except KeyError:
            raise ValueError(f"Got resolution={resolution}, expected one of "
                             f"{sorted(self._RESOLUTION_TO_STEP)}")
        self.filename = str(filename)
        self.transform_x = transform_x
        self.transform_y = transform_y
        self._data = None
        if n_samples is not None:
            self.n_samples = n_samples
        else:
            self.n_samples = zarr.open(self.filename, mode="r").shape[0]

    @property
    def data(self):
        if self._data is None:
            self._data = zarr.open(self.filename, mode="r")
        return self._data

    def attrs(self, array_name: str, name: str):
        return self.data[array_name].attrs[name]

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx):
        if isinstance(idx, int) and idx >= self.n_samples:
            raise IndexError(f"sample {idx} out of range for dataset of {self.n_samples} "
                             "samples")
        step = self.subsample_step
        x = np.asarray(self.data["x"][idx, ::step, ::step], dtype=np.float32)[None]
        y = np.asarray(self.data["y"][idx, ::step, ::step], dtype=np.float32)[None]
        if self.transform_x is not None:
            x = self.transform_x(x)
        if self.transform_y is not None:
            y = self.transform_y(y)
        return {"x": x, "y": y}


__all__ = ["ZarrDataset"]
