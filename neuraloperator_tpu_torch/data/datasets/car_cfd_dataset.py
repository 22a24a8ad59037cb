"""Car-CFD dataset, surface pressure on vehicle meshes (port of
``neuraloperator_tpu/data/datasets/car_cfd_dataset.py``).

``load_mini_car`` reads the reference's 3-sample ``mini_car.pt``, from
``data_root`` or the port's data directory (``darcy.DATA_ROOT``,
gitignored); the repository does not ship it, so without it the loader
raises ``FileNotFoundError``, as the JAX one does without its file.
"""

from pathlib import Path
from typing import List, Optional

import torch

from . import darcy
from .mesh_datamodule import MeshDataModule, _as_numpy


class CarCFDDataset(MeshDataModule):
    """Any ``.pt`` archive of mesh dicts in the car-CFD schema (the full
    set needs a download)."""

    def __init__(self, root_dir, n_train: int = 1, n_test: int = 1,
                 file_name: str = "mini_car.pt", **kwargs):
        super().__init__(root_dir=root_dir, n_train=n_train, n_test=n_test,
                         file_name=file_name, **kwargs)


def load_mini_car(data_root: Optional[str] = None) -> List[dict]:
    """The mini car set as a list of dict samples of numpy arrays."""
    root = Path(data_root) if data_root is not None else darcy.DATA_ROOT
    path = root / "mini_car.pt"
    if not path.exists():
        raise FileNotFoundError(f"mini_car.pt not found in {root}; pass data_root explicitly")
    raw = torch.load(path.as_posix(), weights_only=False)
    return [{k: _as_numpy(v) for k, v in entry.items()} for entry in raw]
