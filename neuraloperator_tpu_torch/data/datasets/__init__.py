from .burgers import BurgersDataset, load_burgers_1d, load_mini_burgers_1dtime
from .darcy import DarcyDataset, load_darcy_flow_small, load_darcy_pt
from .navier_stokes import NavierStokesDataset, load_navier_stokes_pt
from .pt_dataset import PTDataset, load_pt_as_numpy
from .spherical_swe import SphericalSWEDataset, SphericalSWESolver, load_spherical_swe
from .tensor_dataset import DataLoader, TensorDataset

__all__ = ["BurgersDataset", "DarcyDataset", "DataLoader", "NavierStokesDataset", "PTDataset",
           "SphericalSWEDataset", "SphericalSWESolver", "TensorDataset", "load_burgers_1d",
           "load_darcy_flow_small", "load_darcy_pt", "load_mini_burgers_1dtime",
           "load_navier_stokes_pt", "load_pt_as_numpy", "load_spherical_swe"]
