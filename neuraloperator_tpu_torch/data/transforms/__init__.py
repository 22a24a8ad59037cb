from .data_processors import DataProcessor, DefaultDataProcessor, load_data_processor
from .normalizers import UnitGaussianNormalizer

__all__ = ["DataProcessor", "DefaultDataProcessor", "UnitGaussianNormalizer",
           "load_data_processor"]
