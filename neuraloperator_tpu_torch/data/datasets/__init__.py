from .tensor_dataset import DataLoader, TensorDataset

__all__ = ["DataLoader", "TensorDataset"]
