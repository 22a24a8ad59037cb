"""A lazy dataset over an HDF5 file (port of ``neuraloperator_tpu/data/datasets/hdf5_dataset.py``).

Samples are read one at a time from the file's ``x`` and ``y`` arrays as
``{'x', 'y'}`` dicts of f32 numpy arrays, as in the JAX package. ``h5py``
is imported when a dataset is opened, so the package imports without it.
"""

from pathlib import Path
from typing import Optional

import numpy as np


class H5pyDataset:
    """``{'x', 'y'}`` samples of an HDF5 file, subsampled in space by
    ``subsampling_rate``, a channel axis added where the file has none, and
    ``transform_x``/``transform_y`` applied."""

    def __init__(
        self,
        filename,
        *,
        n_samples: Optional[int] = None,
        subsampling_rate: int = 1,
        transform_x=None,
        transform_y=None,
    ):
        import h5py

        self.path = Path(filename)
        self._file = h5py.File(self.path.as_posix(), "r")
        self.data_x = self._file["x"]
        self.data_y = self._file["y"]
        self.subsampling_rate = subsampling_rate or 1
        self.n_samples = n_samples if n_samples is not None else self.data_x.shape[0]
        self.transform_x = transform_x
        self.transform_y = transform_y

    def __len__(self) -> int:
        return self.n_samples

    def __getitem__(self, idx) -> dict:
        rate = self.subsampling_rate
        x = np.asarray(self.data_x[idx], np.float32)
        y = np.asarray(self.data_y[idx], np.float32)
        if rate > 1:
            sl = tuple([slice(None)] + [slice(None, None, rate)] * (x.ndim - 1))
            x, y = x[sl], y[sl]
        if x.ndim == y.ndim and x.ndim >= 2 and x.shape[0] != 1:
            x, y = x[None], y[None]  # a channel axis where the file has none
        if self.transform_x is not None:
            x = self.transform_x(x)
        if self.transform_y is not None:
            y = self.transform_y(y)
        return {"x": x, "y": y}

    def close(self) -> None:
        self._file.close()


__all__ = ["H5pyDataset"]
from .zarr_dataset import ZarrDataset  # noqa: E402,F401
