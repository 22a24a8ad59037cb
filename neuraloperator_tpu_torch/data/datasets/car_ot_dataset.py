"""OT-preprocessed car-CFD samples for OTNO (port of
``neuraloperator_tpu/data/datasets/car_ot_dataset.py``).

``load_car_ot`` reads an archive of precomputed OT samples (latent sphere
grid ``source``, transported coordinates ``trans``, the decoder map
``ind_dec``, surface pressure ``press``) from ``data_root`` or the port's
data directory (``darcy.DATA_ROOT``, gitignored); the repository ships
none, so without one it raises ``FileNotFoundError``, as the JAX loader
does. ``CFDDataProcessor`` turns a sample into OTNO's inputs.
"""

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..transforms.data_processors import DataProcessor
from . import darcy
from .mesh_datamodule import _as_numpy
from .tensor_dataset import DictDataset


def load_car_ot(data_root: Optional[str] = None, file_name: Optional[str] = None):
    """The samples of ``file_name`` (the first ``ot_*.pt`` when None) as
    dicts of numpy arrays."""
    root = Path(data_root) if data_root is not None else darcy.DATA_ROOT
    paths = [root / file_name] if file_name is not None else sorted(root.glob("ot_*.pt"))
    for path in paths:
        if path.exists():
            raw = torch.load(path.as_posix(), weights_only=False)
            return [{k: _as_numpy(v) for k, v in entry.items()} for entry in raw]
    raise FileNotFoundError(f"no ot_*.pt archive found in {root}; pass data_root")


class CarOTDataset:
    """Train/test split over OT car samples."""

    def __init__(self, n_train: int = 2, n_test: int = 1,
                 data_root: Optional[str] = None):
        data = load_car_ot(data_root)
        self.train_data = DictDataset(data[:n_train])
        self.test_data = DictDataset(data[n_train: n_train + n_test])


class CFDDataProcessor(DataProcessor):
    """An OT sample as OTNO's inputs: ``x`` the latent grid's and the
    transported coordinates as a (1, 6, s, s) grid, ``ind_dec`` the decoder
    map, ``y`` the pressure at the mesh's vertices (normalized in training
    when a normalizer is given, the prediction denormalized in evaluation),
    as CPU tensors (the JAX processor returns numpy arrays)."""

    def __init__(self, normalizer=None):
        self.normalizer = normalizer

    def preprocess(self, sample: dict, train: bool = True) -> dict:
        sample = dict(sample)
        trans = np.asarray(sample["trans"], np.float32)
        source = np.asarray(sample["source"], np.float32)
        n = int(round(np.sqrt(trans.shape[0])))
        feats = np.concatenate([source, trans], axis=-1)  # (s*s, 6)
        x = torch.from_numpy(np.ascontiguousarray(feats.T.reshape(1, -1, n, n)))
        press = np.asarray(sample["press"], np.float32)
        ind_dec = torch.from_numpy(np.asarray(sample["ind_dec"], np.int64))
        y = torch.from_numpy(press[: ind_dec.shape[0]][None])  # (1, n_target)
        if self.normalizer is not None and train:
            y = self.normalizer.transform(y)
        sample.update({"x": x, "ind_dec": ind_dec, "y": y})
        return sample

    def postprocess(self, out, sample: dict, train: bool = True):
        if self.normalizer is not None and not train:
            out = self.normalizer.inverse_transform(out)
        return out, sample


# the reference's name for the class that loads its shipped OT archive
load_saved_ot = CarOTDataset
