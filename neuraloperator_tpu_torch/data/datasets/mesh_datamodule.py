"""Mesh data module for CFD-style point-cloud datasets (port of
``neuraloperator_tpu/data/datasets/mesh_datamodule.py``): a ``.pt`` archive
of mesh dicts (vertices, normals, query grids, pressure), read without
open3d into dict samples of numpy arrays."""

from pathlib import Path
from typing import List, Optional

import torch

from .tensor_dataset import DictDataset


def _as_numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "numpy") else v


class MeshDataModule:
    """``train_data``/``test_data`` (``DictDataset``) of the archive
    ``root_dir / (file_name or dataset_name + ".pt")``, keeping ``item_keys``
    when given; by default all samples but one train."""

    def __init__(
        self,
        root_dir,
        dataset_name: Optional[str] = None,
        item_keys: Optional[List[str]] = None,
        n_train: Optional[int] = None,
        n_test: Optional[int] = None,
        file_name: Optional[str] = None,
    ):
        path = Path(root_dir) / (file_name or f"{dataset_name}.pt")
        raw = torch.load(path.as_posix(), weights_only=False)
        data = [{k: _as_numpy(v) for k, v in entry.items()
                 if item_keys is None or k in item_keys} for entry in raw]
        n_train = n_train if n_train is not None else max(len(data) - 1, 1)
        n_test = n_test if n_test is not None else len(data) - n_train
        self.train_data = DictDataset(data[:n_train])
        self.test_data = DictDataset(data[n_train:n_train + n_test])
        self.data = data
