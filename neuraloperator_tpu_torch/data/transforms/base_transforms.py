"""Transform base classes (port of ``neuraloperator_tpu/data/transforms/base_transforms.py``):
the ``Transform`` interface with ``transform``/``inverse_transform``, and
its sequential and per-key variants."""

from typing import Dict, List


class Transform:
    """The interface; calling a transform applies ``transform``."""

    def transform(self, x):
        raise NotImplementedError

    def inverse_transform(self, x):
        raise NotImplementedError

    def __call__(self, x):
        return self.transform(x)


class CompositeTransform(Transform):
    """Transforms applied in sequence, inverted in reverse order."""

    def __init__(self, transforms: List[Transform]):
        self.transforms = list(transforms)

    def transform(self, x):
        for t in self.transforms:
            x = t.transform(x)
        return x

    def inverse_transform(self, x):
        for t in reversed(self.transforms):
            x = t.inverse_transform(x)
        return x


class DictTransform(Transform):
    """Per-key transforms of dict samples; keys without one pass through."""

    def __init__(self, transform_dict: Dict[str, Transform]):
        self.transform_dict = dict(transform_dict)

    def transform(self, sample: dict) -> dict:
        return {k: (self.transform_dict[k].transform(v) if k in self.transform_dict else v)
                for k, v in sample.items()}

    def inverse_transform(self, sample: dict) -> dict:
        return {k: (self.transform_dict[k].inverse_transform(v)
                    if k in self.transform_dict else v)
                for k, v in sample.items()}
