"""1-D viscous Burgers pairs (port of ``neuraloperator_tpu/data/datasets/burgers.py``).

``burgers_{split}_{res}.pt`` files under ``data_root``, or under this
package's data directory (``DATA_ROOT``, the Darcy files' directory), where
``load_burgers_1d`` generates them with the seeded pseudo-spectral solver
of :mod:`.synthetic` when they are missing. ``train_burgers_pino`` keeps
its space-time files there too. Nothing is downloaded, and nothing is
written into the JAX package.
"""

from pathlib import Path
from typing import List, Optional

from . import darcy
from .pt_dataset import PTDataset
from .synthetic import generate_burgers_files
from .tensor_dataset import DataLoader

# where the files are looked for, and generated when missing
DATA_ROOT = darcy.DATA_ROOT


def _find_root(explicit: Optional[str] = None) -> Optional[Path]:
    """``explicit`` as given, else ``DATA_ROOT`` when it holds
    ``burgers_train_16.pt`` (the JAX loader's search, over this package's
    directory)."""
    if explicit is not None:
        return Path(explicit)
    if (DATA_ROOT / "burgers_train_16.pt").exists():
        return DATA_ROOT
    return None


class BurgersDataset(PTDataset):
    """The 1-D Burgers ``PTDataset``."""

    def __init__(
        self,
        root_dir,
        n_train: int,
        n_tests: List[int],
        batch_size: int,
        test_batch_sizes: List[int],
        train_resolution: int = 16,
        test_resolutions: List[int] = (16,),
        **kwargs,
    ):
        super().__init__(
            root_dir=root_dir,
            dataset_name="burgers",
            n_train=n_train,
            n_tests=n_tests,
            batch_size=batch_size,
            test_batch_sizes=test_batch_sizes,
            train_resolution=train_resolution,
            test_resolutions=list(test_resolutions),
            **kwargs,
        )


def load_burgers_1d(
    n_train: int,
    n_tests: List[int],
    batch_size: int,
    test_batch_sizes: List[int],
    data_root: Optional[str] = None,
    train_resolution: int = 16,
    test_resolutions: List[int] = (16,),
    seed: int = 0,
    **kwargs,
):
    """``(train_loader, test_loaders, data_processor)`` of the Burgers pairs.

    The files come from ``data_root``, or from ``DATA_ROOT``, generated there
    when it holds no ``burgers_train_16.pt`` (``max(n_train, 100)`` training
    pairs, ``max(max(n_tests), 50)`` test pairs, at ``train_resolution``).
    The training loader shuffles with ``seed``.
    """
    root = _find_root(data_root)
    if root is None:
        root = DATA_ROOT
        generate_burgers_files(
            root, n_train=max(n_train, 100), n_test=max(max(n_tests), 50),
            res=train_resolution,
        )
    ds = BurgersDataset(
        root_dir=root,
        n_train=n_train,
        n_tests=n_tests,
        batch_size=batch_size,
        test_batch_sizes=test_batch_sizes,
        train_resolution=train_resolution,
        test_resolutions=list(test_resolutions),
        **kwargs,
    )
    train_loader = DataLoader(ds.train_db, batch_size, shuffle=True, seed=seed)
    test_loaders = {
        res: DataLoader(db, bs)
        for (res, db), bs in zip(ds.test_dbs.items(), test_batch_sizes)
    }
    return train_loader, test_loaders, ds.data_processor


def load_mini_burgers_1dtime(*args, **kwargs):
    """``load_burgers_1d`` under the name the reference scripts use."""
    return load_burgers_1d(*args, **kwargs)
