"""The small Darcy-flow dataset (port of ``neuraloperator_tpu/data/datasets/darcy.py``).

16x16 training pairs with test splits at 16 and 32 by default: the
``darcy_{split}_{res}.pt`` files under ``data_root``, or under this
package's data directory (``DATA_ROOT``), where ``load_darcy_flow_small``
generates them with the seeded scipy solver of :mod:`.synthetic` when they
are missing. Nothing is downloaded, and nothing is written into the JAX
package.
"""

import tempfile
from pathlib import Path
from typing import List, Optional

from .pt_dataset import PTDataset
from .synthetic import generate_darcy_files
from .tensor_dataset import DataLoader

# where the example files are looked for, and generated when missing
DATA_ROOT = Path(__file__).resolve().parent / "data"


def _find_root(explicit: Optional[str] = None) -> Optional[Path]:
    """``explicit`` as given, else ``DATA_ROOT`` when it holds the training
    file (the JAX loader's search, over this package's directory)."""
    if explicit is not None:
        return Path(explicit)
    if (DATA_ROOT / "darcy_train_16.pt").exists():
        return DATA_ROOT
    return None


class DarcyDataset(PTDataset):
    """The Darcy-flow ``PTDataset`` (normalizers fitted on the train split)."""

    def __init__(
        self,
        root_dir,
        n_train: int,
        n_tests: List[int],
        batch_size: int,
        test_batch_sizes: List[int],
        train_resolution: int = 16,
        test_resolutions: List[int] = (16, 32),
        encode_input: bool = False,
        encode_output: bool = True,
        encoding="channel-wise",
        channel_dim=1,
        **kwargs,
    ):
        super().__init__(
            root_dir=root_dir,
            dataset_name="darcy",
            n_train=n_train,
            n_tests=n_tests,
            batch_size=batch_size,
            test_batch_sizes=test_batch_sizes,
            train_resolution=train_resolution,
            test_resolutions=list(test_resolutions),
            encode_input=encode_input,
            encode_output=encode_output,
            encoding=encoding,
            channel_dim=channel_dim,
            **kwargs,
        )


def load_darcy_flow_small(
    n_train: int,
    n_tests: List[int],
    batch_size: int,
    test_batch_sizes: List[int],
    test_resolutions: List[int] = (16, 32),
    data_root: Optional[str] = None,
    encode_input: bool = False,
    encode_output: bool = True,
    encoding: str = "channel-wise",
    seed: int = 0,
    train_resolution: int = 16,
):
    """``(train_loader, test_loaders, data_processor)`` of the small Darcy set.

    At ``train_resolution`` 16 the files come from ``data_root``, or from
    ``DATA_ROOT``, generated there when missing (``max(n_train, 100)``
    training pairs, ``max(max(n_tests), 50)`` per test resolution). Other
    training resolutions read ``data_root``, or a directory of the system's
    temporary directory keyed by the resolution and the counts, generating
    whatever split is missing. The training loader shuffles with ``seed``.
    """
    n_test_req = max(max(n_tests), 50)
    if train_resolution == 16:
        root = _find_root(data_root)
        if root is None:
            root = DATA_ROOT
            generate_darcy_files(
                root,
                n_train=max(n_train, 100),
                n_test=n_test_req,
                resolutions=sorted(set([16] + list(test_resolutions))),
            )
    else:
        resolutions = sorted(set([train_resolution] + list(test_resolutions)))
        root = (
            Path(data_root)
            if data_root is not None
            else Path(tempfile.gettempdir())
            / f"neuraloperator_tpu_darcy_r{train_resolution}_n{max(n_train, 100)}_t{n_test_req}"
        )
        if not all(
            (root / f"darcy_{split}_{r}.pt").exists()
            for r in resolutions
            for split in ("train", "test")
        ):
            generate_darcy_files(
                root,
                n_train=max(n_train, 100),
                n_test=n_test_req,
                resolutions=resolutions,
            )

    dataset = DarcyDataset(
        root_dir=root,
        n_train=n_train,
        n_tests=n_tests,
        batch_size=batch_size,
        test_batch_sizes=test_batch_sizes,
        train_resolution=train_resolution,
        test_resolutions=list(test_resolutions),
        encode_input=encode_input,
        encode_output=encode_output,
        encoding=encoding,
    )
    train_loader = DataLoader(dataset.train_db, batch_size=batch_size, shuffle=True, seed=seed)
    test_loaders = {
        res: DataLoader(db, batch_size=bs, shuffle=False)
        for (res, db), bs in zip(dataset.test_dbs.items(), test_batch_sizes)
    }
    return train_loader, test_loaders, dataset.data_processor


def load_darcy_pt(
    n_train: int,
    n_tests: List[int],
    batch_size: int,
    test_batch_sizes: List[int],
    data_root: Optional[str] = None,
    train_resolution: int = 16,
    test_resolutions: List[int] = (16, 32),
    encode_input: bool = False,
    encode_output: bool = True,
    encoding: str = "channel-wise",
    channel_dim: int = 1,
    **kwargs,
):
    """``(train_loader, test_loaders, data_processor)`` of the Darcy ``.pt``
    files under ``data_root`` (``DATA_ROOT`` when None) at a chosen training
    resolution; nothing is generated, and the loaders do not shuffle."""
    root = _find_root(data_root)
    if root is None:
        raise FileNotFoundError(
            f"no darcy_train_16.pt under {DATA_ROOT}; pass data_root, or generate the files "
            "with load_darcy_flow_small or synthetic.generate_darcy_files")
    dataset = DarcyDataset(
        root_dir=root,
        n_train=n_train,
        n_tests=n_tests,
        batch_size=batch_size,
        test_batch_sizes=test_batch_sizes,
        train_resolution=train_resolution,
        test_resolutions=list(test_resolutions),
        encode_input=encode_input,
        encode_output=encode_output,
        encoding=encoding,
        channel_dim=channel_dim,
    )
    train_loader = DataLoader(dataset.train_db, batch_size)
    test_loaders = {
        res: DataLoader(db, bs)
        for (res, db), bs in zip(dataset.test_dbs.items(), test_batch_sizes)
    }
    return train_loader, test_loaders, dataset.data_processor
