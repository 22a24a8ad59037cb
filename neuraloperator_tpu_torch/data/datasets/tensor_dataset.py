"""In-memory tensor dataset and batch loader.

Port of ``neuraloperator_tpu/data/datasets/tensor_dataset.py``.

Samples are dicts of numpy arrays and the loader yields stacked dict
batches of numpy arrays, as in the JAX package; the ``Trainer`` moves each
batch to its device. The shuffle draws from ``np.random.RandomState(seed)``
exactly as the JAX loader does, so one seed visits the samples in the same
order in both packages.
"""

from typing import Dict, Iterator, List, Optional

import numpy as np


class TensorDataset:
    """Dict-of-arrays dataset: sample i is ``{'x': x[i], 'y': y[i], ...}``."""

    def __init__(self, x, y, **extras):
        if len(x) != len(y):
            raise ValueError("x and y must have the same first dim")
        self.arrays: Dict[str, np.ndarray] = {"x": np.asarray(x), "y": np.asarray(y)}
        for k, v in extras.items():
            if len(v) != len(x):
                raise ValueError(f"{k} must have the same first dim as x")
            self.arrays[k] = np.asarray(v)

    def __len__(self) -> int:
        return len(self.arrays["x"])

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[i] for k, v in self.arrays.items()}


class DictDataset:
    """A dataset over a list of dict samples; ``constant`` entries are added
    to every sample."""

    def __init__(self, data_list: List[dict], constant: Optional[dict] = None):
        self.data_list = data_list
        self.constant = constant or {}

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, i: int) -> dict:
        return {**self.data_list[i], **self.constant}



class GeneralTensorDataset:
    """Aligned arrays, each with its transform (None for none): item ``i`` is
    the list of every array's transformed ``i``-th entry, or that entry
    alone when there is one array."""

    def __init__(self, sets, transforms):
        if len(sets) != len(transforms):
            raise ValueError("Size mismatch between number of tensors and transforms")
        if any(len(s) != len(sets[0]) for s in sets[1:]):
            raise ValueError("Size mismatch between tensors")
        self.sets = sets
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.sets[0])

    def __getitem__(self, index):
        items = [s[index] if t is None else t(s[index])
                 for s, t in zip(self.sets, self.transforms)]
        return items if len(items) > 1 else items[0]

class DataLoader:
    """Epoch iterator over a dataset, yielding dict batches of numpy arrays."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = order[start:start + self.batch_size]
            if hasattr(self.dataset, "arrays"):
                yield {k: v[idx] for k, v in self.dataset.arrays.items()}
            else:
                samples = [self.dataset[int(i)] for i in idx]
                yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
