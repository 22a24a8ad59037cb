"""Data processors (port of ``neuraloperator_tpu/data/transforms/data_processors.py``).

The ``DataProcessor`` interface, ``DefaultDataProcessor`` (preprocess, postprocess, feedback, state),
``load_data_processor``, which reads the ``data_processor.json`` sidecar
saved beside a checkpoint, ``IncrementalDataProcessor`` (an epoch schedule
of input subsampling) and ``MGPatchingDataProcessor`` (multigrid patching
around the model, ``training/patching.py``).
"""

import json
from pathlib import Path
from typing import Optional

from .normalizers import UnitGaussianNormalizer


class DataProcessor:
    """The interface: ``preprocess`` before the model, ``postprocess``
    after it, each with an explicit ``train`` flag."""

    def preprocess(self, sample: dict, train: bool = True) -> dict:
        raise NotImplementedError

    def postprocess(self, out, sample: dict, train: bool = True):
        raise NotImplementedError


class DefaultDataProcessor(DataProcessor):
    """Normalize x always; normalize y in training, denormalize predictions in eval.

    Serving bakes ``in_normalizer.transform`` in before the model and
    ``out_normalizer.inverse_transform`` after it.
    """

    def __init__(self, in_normalizer=None, out_normalizer=None):
        self.in_normalizer = in_normalizer
        self.out_normalizer = out_normalizer

    def preprocess(self, sample: dict, train: bool = True) -> dict:
        sample = dict(sample)
        if self.in_normalizer is not None:
            sample["x"] = self.in_normalizer.transform(sample["x"])
        if self.out_normalizer is not None and train:
            sample["y"] = self.out_normalizer.transform(sample["y"])
        return sample

    def postprocess(self, out, sample: dict, train: bool = True):
        if self.out_normalizer is not None and not train:
            out = self.out_normalizer.inverse_transform(out)
        return out, sample

    def feedback(self, out):
        """An encoded-y prediction mapped to the encoded-x input space: the
        out-normalizer inverted, then the in-normalizer applied. Rollout
        training feeds the model its own prediction through it."""
        if self.out_normalizer is not None:
            out = self.out_normalizer.inverse_transform(out)
        if self.in_normalizer is not None:
            out = self.in_normalizer.transform(out)
        return out

    def state_dict(self) -> dict:
        """JSON-serializable fitted state, as saved in the checkpoint sidecar."""
        return {
            "type": "DefaultDataProcessor",
            "in_normalizer": (
                None if self.in_normalizer is None else self.in_normalizer.state_dict()
            ),
            "out_normalizer": (
                None if self.out_normalizer is None else self.out_normalizer.state_dict()
            ),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "DefaultDataProcessor":
        def norm(s):
            return None if s is None else UnitGaussianNormalizer.from_state_dict(s)

        return cls(
            in_normalizer=norm(state.get("in_normalizer")),
            out_normalizer=norm(state.get("out_normalizer")),
        )


def load_data_processor(
    save_dir, filename: str = "data_processor.json"
) -> Optional[DefaultDataProcessor]:
    """The data processor saved beside a checkpoint, or None when there is none."""
    path = Path(save_dir) / filename
    if not path.exists():
        return None
    state = json.loads(path.read_text())
    registry = {"DefaultDataProcessor": DefaultDataProcessor}
    klass = registry.get(state.get("type"))
    if klass is None:
        raise ValueError(f"unknown data processor type {state.get('type')!r} in {path}")
    return klass.from_state_dict(state)


class IncrementalDataProcessor(DataProcessor):
    """Epoch-scheduled resolution curriculum: the training inputs and targets
    are subsampled along ``dataset_indices`` by ``subsampling_rates[i]``,
    where ``i`` moves one step every ``epoch_gap`` epochs (``step(epoch)``).
    Evaluation sees the full resolution."""

    def __init__(
        self,
        in_normalizer=None,
        out_normalizer=None,
        *,
        subsampling_rates=(2, 1),
        dataset_resolution: int = 16,
        dataset_indices=(2, 3),
        epoch_gap: int = 10,
        verbose: bool = False,
    ):
        self.in_normalizer = in_normalizer
        self.out_normalizer = out_normalizer
        self.subsampling_rates = list(subsampling_rates)
        self.dataset_resolution = dataset_resolution
        self.dataset_indices = list(dataset_indices)
        self.epoch_gap = epoch_gap
        self.verbose = verbose
        self.epoch = 0
        self.current_index = 0

    def epoch_wise_res_increase(self, epoch: int) -> None:
        if (epoch % self.epoch_gap == 0 and epoch != 0
                and self.current_index < len(self.subsampling_rates) - 1):
            self.current_index += 1
            if self.verbose:
                print(f"Incremental resolution: rate "
                      f"{self.subsampling_rates[self.current_index]} at epoch {epoch}")

    def step(self, epoch: int) -> None:
        self.epoch = epoch
        self.epoch_wise_res_increase(epoch)

    def regularize_input_res(self, x, y):
        rate = self.subsampling_rates[self.current_index]
        if rate > 1:
            idx = [slice(None)] * x.ndim
            for d in self.dataset_indices:
                idx[d] = slice(None, None, rate)
            x = x[tuple(idx)]
            y = y[tuple(idx)]
        return x, y

    def preprocess(self, sample: dict, train: bool = True) -> dict:
        sample = dict(sample)
        if self.in_normalizer is not None:
            sample["x"] = self.in_normalizer.transform(sample["x"])
        if self.out_normalizer is not None and train:
            sample["y"] = self.out_normalizer.transform(sample["y"])
        if train:
            sample["x"], sample["y"] = self.regularize_input_res(sample["x"], sample["y"])
        return sample

    def postprocess(self, out, sample: dict, train: bool = True):
        if self.out_normalizer is not None and not train:
            out = self.out_normalizer.inverse_transform(out)
        return out, sample


class MGPatchingDataProcessor(DataProcessor):
    """Multigrid patching around the model, inside an optional normalization.

    ``preprocess`` normalizes (``y`` in training only), then patches ``x``
    (and ``y`` when ``stitching=False``); ``postprocess`` unpads and
    stitches the output (and, in evaluation with ``stitching=False``, ``y``),
    then inverse-normalizes the output in evaluation only.
    """

    def __init__(
        self,
        *,
        levels: int = 0,
        padding_fraction=0,
        stitching: bool = True,
        use_distributed: bool = False,
        mesh=None,
        in_normalizer=None,
        out_normalizer=None,
    ):
        from ...training.patching import MultigridPatching2D

        self.patcher = MultigridPatching2D(
            levels=levels, padding_fraction=padding_fraction,
            use_distributed=use_distributed, stitching=stitching, mesh=mesh,
        )
        self.in_normalizer = in_normalizer
        self.out_normalizer = out_normalizer

    def preprocess(self, sample: dict, train: bool = True) -> dict:
        sample = dict(sample)
        if self.in_normalizer is not None:
            sample["x"] = self.in_normalizer.transform(sample["x"])
        if self.out_normalizer is not None and train:
            sample["y"] = self.out_normalizer.transform(sample["y"])
        sample["x"], sample["y"] = self.patcher.patch(sample["x"], sample["y"])
        return sample

    def postprocess(self, out, sample: dict, train: bool = True):
        out, y = self.patcher.unpatch(out, sample["y"], evaluation=not train)
        if self.out_normalizer is not None and not train:
            out = self.out_normalizer.inverse_transform(out)
        sample = dict(sample)
        sample["y"] = y
        return out, sample
