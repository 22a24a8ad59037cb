from .base_transforms import CompositeTransform, DictTransform, Transform
from .data_processors import (
    DataProcessor,
    DefaultDataProcessor,
    IncrementalDataProcessor,
    MGPatchingDataProcessor,
    load_data_processor,
)
from .normalizers import DictUnitGaussianNormalizer, UnitGaussianNormalizer
from .patching_transforms import MGPatchingTransform, MGPTensorDataset, RandomMGPatch
from .the_well_data_processors import TheWellDataProcessor

__all__ = ["CompositeTransform", "DataProcessor", "DefaultDataProcessor", "DictTransform",
           "DictUnitGaussianNormalizer",
           "IncrementalDataProcessor", "MGPTensorDataset", "MGPatchingDataProcessor",
           "MGPatchingTransform", "RandomMGPatch", "TheWellDataProcessor", "Transform",
           "UnitGaussianNormalizer",
           "load_data_processor"]
