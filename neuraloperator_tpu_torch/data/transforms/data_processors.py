"""Data processors (port of ``neuraloperator_tpu/data/transforms/data_processors.py``).

``DefaultDataProcessor`` state and ``load_data_processor``, which reads the
``data_processor.json`` sidecar saved beside a checkpoint.
"""

import json
from pathlib import Path
from typing import Optional

from .normalizers import UnitGaussianNormalizer


class DefaultDataProcessor:
    """The input and output normalizers a model was trained with.

    Serving bakes ``in_normalizer.transform`` in before the model and
    ``out_normalizer.inverse_transform`` after it.
    """

    def __init__(self, in_normalizer=None, out_normalizer=None):
        self.in_normalizer = in_normalizer
        self.out_normalizer = out_normalizer

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
