from .navier_stokes import NavierStokesDataset, load_navier_stokes_pt
from .pt_dataset import PTDataset, load_pt_as_numpy
from .tensor_dataset import DataLoader, TensorDataset

__all__ = ["DataLoader", "NavierStokesDataset", "PTDataset", "TensorDataset",
           "load_navier_stokes_pt", "load_pt_as_numpy"]
