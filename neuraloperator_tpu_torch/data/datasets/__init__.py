from .pt_dataset import load_pt_as_numpy
from .tensor_dataset import DataLoader, TensorDataset

__all__ = ["DataLoader", "TensorDataset", "load_pt_as_numpy"]
