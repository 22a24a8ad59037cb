"""Data processors (port of ``neuraloperator_tpu/data/transforms/data_processors.py``).

``DefaultDataProcessor`` (preprocess, postprocess, state) and
``load_data_processor``, which reads the ``data_processor.json`` sidecar
saved beside a checkpoint.
"""

import json
from pathlib import Path
from typing import Optional

from .normalizers import UnitGaussianNormalizer


class DefaultDataProcessor:
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
