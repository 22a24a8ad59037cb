from .data_processors import DefaultDataProcessor, load_data_processor
from .normalizers import UnitGaussianNormalizer

__all__ = ["DefaultDataProcessor", "UnitGaussianNormalizer", "load_data_processor"]
