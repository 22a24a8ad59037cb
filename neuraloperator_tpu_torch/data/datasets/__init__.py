from .burgers import BurgersDataset, load_burgers_1d, load_mini_burgers_1dtime
from .car_cfd_dataset import CarCFDDataset, load_mini_car
from .car_ot_dataset import CarOTDataset, CFDDataProcessor, load_car_ot, load_saved_ot
from .darcy import DarcyDataset, load_darcy_flow_small, load_darcy_pt
from .hdf5_dataset import H5pyDataset
from .mesh_datamodule import MeshDataModule
from .navier_stokes import NavierStokesDataset, load_navier_stokes_pt
from .nonlinear_poisson import (
    NonlinearPoissonDataset,
    PoissonGINODataProcessor,
    generate_latent_queries,
    generate_output_queries,
    load_nonlinear_poisson_pt,
)
from .ot_datamodule import OTDataModule, sinkhorn_log
from .prefetch import PrefetchLoader
from .pt_dataset import PTDataset, load_pt_as_numpy
from .spherical_swe import SphericalSWEDataset, SphericalSWESolver, load_spherical_swe
from .synthetic_cfd import generate_cfd_sample, load_synthetic_cfd
from .tensor_dataset import DataLoader, DictDataset, GeneralTensorDataset, TensorDataset
from .the_well_dataset import ActiveMatterDataset, MHD64Dataset, WellDataset
from .web_utils import (
    calculate_md5,
    check_integrity,
    check_md5,
    download_from_url,
    download_from_zenodo_record,
)
from .zarr_dataset import ZarrDataset

__all__ = ["ActiveMatterDataset", "BurgersDataset", "CFDDataProcessor", "CarCFDDataset", "CarOTDataset",
           "DarcyDataset", "DataLoader", "DictDataset", "GeneralTensorDataset", "H5pyDataset",
           "MHD64Dataset", "MeshDataModule",
           "NavierStokesDataset", "NonlinearPoissonDataset", "OTDataModule",
           "PTDataset", "PrefetchLoader", "PoissonGINODataProcessor", "SphericalSWEDataset",
           "SphericalSWESolver", "TensorDataset", "WellDataset", "ZarrDataset",
           "calculate_md5", "check_integrity", "check_md5", "download_from_url",
           "download_from_zenodo_record", "generate_cfd_sample",
           "generate_latent_queries", "generate_output_queries", "load_burgers_1d",
           "load_car_ot", "load_darcy_flow_small", "load_darcy_pt",
           "load_mini_burgers_1dtime", "load_mini_car", "load_navier_stokes_pt",
           "load_nonlinear_poisson_pt", "load_pt_as_numpy", "load_saved_ot",
           "load_spherical_swe", "load_synthetic_cfd", "sinkhorn_log"]
