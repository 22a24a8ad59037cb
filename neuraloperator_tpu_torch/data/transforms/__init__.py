from .base_transforms import CompositeTransform, DictTransform, Transform
from .data_processors import (
    DataProcessor,
    DefaultDataProcessor,
    IncrementalDataProcessor,
    MGPatchingDataProcessor,
    load_data_processor,
)
from .normalizers import UnitGaussianNormalizer
from .patching_transforms import MGPatchingTransform, MGPTensorDataset, RandomMGPatch

__all__ = ["CompositeTransform", "DataProcessor", "DefaultDataProcessor", "DictTransform",
           "IncrementalDataProcessor", "MGPTensorDataset", "MGPatchingDataProcessor",
           "MGPatchingTransform", "RandomMGPatch", "Transform", "UnitGaussianNormalizer",
           "load_data_processor"]
