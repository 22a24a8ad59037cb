"""``.pt`` splits as datasets (port of ``neuraloperator_tpu/data/datasets/pt_dataset.py``).

``PTDataset`` loads ``{name}_{split}_{res}.pt`` dicts of ``x``/``y``
tensors into numpy, adds the squeezed channel dim, keeps the first ``n``
samples (subsampling the grid when asked), fits channel-wise
``UnitGaussianNormalizer``s on the train split, and exposes ``train_db``,
``test_dbs`` and ``data_processor``, as in the JAX package.
"""

from pathlib import Path
from typing import List, Union

import numpy as np
import torch

from ..transforms.data_processors import DefaultDataProcessor
from ..transforms.normalizers import UnitGaussianNormalizer
from .tensor_dataset import TensorDataset


def load_pt_as_numpy(path) -> dict:
    """A ``.pt`` dict of tensors (as ``scripts/generate_ns_data.py`` writes
    one) as numpy arrays; bool tensors become float32.

    Loaded with ``weights_only=True``: a split holds tensors, never code.
    """
    data = torch.load(Path(path).as_posix(), weights_only=True)
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bool:
                v = v.float()
            out[k] = v.numpy()
        else:
            out[k] = v
    return out


class PTDataset:
    """Train and test splits of one ``.pt`` dataset, with fitted normalizers."""

    def __init__(
        self,
        root_dir: Union[Path, str],
        dataset_name: str,
        n_train: int,
        n_tests: List[int],
        batch_size: int,
        test_batch_sizes: List[int],
        train_resolution: int,
        test_resolutions: List[int],
        encode_input: bool = False,
        encode_output: bool = True,
        encoding: str = "channel-wise",
        input_subsampling_rate=None,
        output_subsampling_rate=None,
        channel_dim: int = 1,
        channels_squeezed: bool = True,
    ):
        root_dir = Path(root_dir)
        self.batch_size = batch_size
        self.test_resolutions = test_resolutions
        self.test_batch_sizes = test_batch_sizes

        x_train, y_train = self._load(
            root_dir / f"{dataset_name}_train_{train_resolution}.pt", n_train,
            input_subsampling_rate, output_subsampling_rate, channel_dim, channels_squeezed)
        input_encoder = None
        if encode_input:
            input_encoder = UnitGaussianNormalizer(
                dim=self._reduce_dims(x_train.ndim, channel_dim, encoding)
            ).fit(x_train)
        output_encoder = None
        if encode_output:
            output_encoder = UnitGaussianNormalizer(
                dim=self._reduce_dims(y_train.ndim, channel_dim, encoding)
            ).fit(y_train)
        self._train_db = TensorDataset(x_train, y_train)
        self._data_processor = DefaultDataProcessor(
            in_normalizer=input_encoder, out_normalizer=output_encoder
        )
        self._test_dbs = {}
        for res, n_test in zip(test_resolutions, n_tests):
            self._test_dbs[res] = TensorDataset(*self._load(
                root_dir / f"{dataset_name}_test_{res}.pt", n_test, input_subsampling_rate,
                output_subsampling_rate, channel_dim, channels_squeezed))

    @classmethod
    def _load(cls, path, n, in_rate, out_rate, channel_dim, channels_squeezed):
        data = load_pt_as_numpy(path)
        x = np.asarray(data["x"], dtype=np.float32)
        y = np.asarray(data["y"], dtype=np.float32)
        if channels_squeezed:
            x = np.expand_dims(x, channel_dim)
            y = np.expand_dims(y, channel_dim)
        return (cls._subsample(x, n, in_rate, channel_dim),
                cls._subsample(y, n, out_rate, channel_dim))

    @staticmethod
    def _reduce_dims(ndim: int, channel_dim: int, encoding: str):
        if encoding == "channel-wise":
            dims = list(range(ndim))
            dims.pop(channel_dim)
            return dims
        if encoding == "pixel-wise":
            return [0]
        raise ValueError(f"unknown encoding {encoding}")

    @staticmethod
    def _subsample(arr, n: int, rate, channel_dim: int):
        spatial_dims = arr.ndim - 2
        if not rate:
            rate = 1
        if not isinstance(rate, list):
            rate = [rate] * spatial_dims
        if len(rate) != spatial_dims:
            raise ValueError(f"{len(rate)} subsampling rates for {spatial_dims} spatial dims")
        idx = [slice(0, n)] + [slice(None, None, r) for r in rate]
        idx.insert(channel_dim, slice(None))
        return arr[tuple(idx)]

    @property
    def data_processor(self):
        return self._data_processor

    @property
    def train_db(self):
        return self._train_db

    @property
    def test_dbs(self):
        return self._test_dbs
