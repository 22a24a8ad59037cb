"""Navier–Stokes (2-D vorticity) dataset (port of
``neuraloperator_tpu/data/datasets/navier_stokes.py``).

``load_navier_stokes_pt`` and ``NavierStokesDataset`` read
``nsforcing_{split}_{res}.pt`` files from ``DATA_ROOT`` (or a given root)
and, where a file is missing, write it first with
``generate_navier_stokes_files``: GRF initial fields drawn per sample from
one numpy ``rng`` (the JAX package's draws, in its order), each evolved to
``T`` by ``solve_navier_stokes_2d``. That solver is the JAX module's
pseudo-spectral scheme (Crank–Nicolson viscous term, explicit advection
and forcing) on ``torch.fft`` in float64, as the JAX module runs it in
numpy's float64, batched over the samples on the device. It is the
fallback generator of the loader; the flagship's data comes from
``ns_solver.py`` (``scripts/generate_ns_data.py``).
"""

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..._common import resolve_device
from .pt_dataset import PTDataset
from .synthetic import gaussian_random_field
from .tensor_dataset import DataLoader

# Where both packages' generators write their splits (the JAX package's data
# directory), so that a split made by either serves both. Read at call time:
# tests point it elsewhere.
DATA_ROOT = Path(__file__).resolve().parents[3] / "neuraloperator_tpu/data/datasets/data"
# samples solved at once by generate_navier_stokes_files
_SOLVE_BATCH = 256


def solve_navier_stokes_2d(
    w0,
    visc: float = 1e-3,
    T: float = 1.0,
    delta_t: float = 1e-3,
    record_steps: int = 1,
    forcing_amp: float = 0.1,
    *,
    device="cuda",
) -> torch.Tensor:
    """Evolve vorticity ``w0`` ((..., n, n), any leading batch dims) on the torus.

    Returns the float64 vorticity at ``T`` on ``device`` (shape of ``w0``),
    or with ``record_steps > 1`` the ``record_steps`` snapshots stacked
    along a new first axis, as the JAX function does for one field.
    """
    device = resolve_device(device)
    w0 = torch.as_tensor(np.asarray(w0, dtype=np.float64)).to(device)
    n = w0.shape[-1]
    # the spectral constants in numpy, as the JAX function forms them
    k = np.fft.fftfreq(n, d=1.0 / n)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    lap = -(4 * np.pi ** 2) * (kx ** 2 + ky ** 2)
    lap_inv = np.where(lap == 0, 1.0, lap)
    xs = np.linspace(0, 1, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    forcing = forcing_amp * (np.sin(2 * np.pi * (X + Y)) + np.cos(2 * np.pi * (X + Y)))
    c = {name: torch.as_tensor(v).to(device) for name, v in dict(
        i_kx=2j * np.pi * kx, i_ky=2j * np.pi * ky, minus_i_kx=-2j * np.pi * kx,
        lap_inv=lap_inv, num=1 + 0.5 * delta_t * visc * lap,
        den=1 - 0.5 * delta_t * visc * lap, dt_f_h=delta_t * np.fft.fft2(forcing),
    ).items()}

    w_h = torch.fft.fft2(w0)
    steps = int(T / delta_t)
    record_every = max(steps // max(record_steps, 1), 1)
    out = []
    for s in range(steps):
        psi_h = w_h / c["lap_inv"]
        u = torch.fft.ifft2(c["i_ky"] * psi_h).real
        v = torch.fft.ifft2(c["minus_i_kx"] * psi_h).real
        w_x = torch.fft.ifft2(c["i_kx"] * w_h).real
        w_y = torch.fft.ifft2(c["i_ky"] * w_h).real
        nonlinear_h = torch.fft.fft2(u * w_x + v * w_y)
        w_h = (w_h * c["num"] - delta_t * nonlinear_h + c["dt_f_h"]) / c["den"]
        if record_steps > 1 and (s + 1) % record_every == 0:
            out.append(torch.fft.ifft2(w_h).real)
    return torch.stack(out) if record_steps > 1 else torch.fft.ifft2(w_h).real


def generate_navier_stokes_files(root, n_train=64, n_test=16, res=64, visc=1e-3, T=1.0,
                                 seed=0, *, device="cuda"):
    """Write ``nsforcing_{train,test}_{res}.pt`` (vorticity -> vorticity at ``T``).

    The initial fields are ``gaussian_random_field(rng, res, 2.5, 7.0) * 5``
    drawn one sample at a time from ``default_rng(seed)``, train first, as
    the JAX generator draws them; the solves run in batches on ``device``.
    A split of no samples is not written.
    """
    device = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    delta_t = 5e-4 if res <= 64 else 2.5e-4
    for split, n_samples in (("train", n_train), ("test", n_test)):
        if n_samples <= 0:
            continue  # an empty file would suppress a later regeneration
        w0 = np.stack([gaussian_random_field(rng, res, alpha=2.5, tau=7.0) * 5
                       for _ in range(n_samples)])
        ys = np.concatenate([
            solve_navier_stokes_2d(w0[i:i + _SOLVE_BATCH], visc=visc, T=T, delta_t=delta_t,
                                   device=device).cpu().numpy().astype(np.float32)
            for i in range(0, n_samples, _SOLVE_BATCH)
        ])
        torch.save(
            {"x": torch.from_numpy(w0.astype(np.float32)), "y": torch.from_numpy(ys)},
            (root / f"nsforcing_{split}_{res}.pt").as_posix(),
        )


def load_navier_stokes_pt(
    n_train: int,
    n_tests: List[int],
    batch_size: int,
    test_batch_sizes: List[int],
    data_root: Optional[str] = None,
    train_resolution: int = 64,
    test_resolutions: List[int] = (64,),
    encode_input: bool = True,
    encode_output: bool = True,
    seed: int = 0,
    *,
    device="cuda",
    **kwargs,
):
    """``(train_loader, test_loaders, data_processor)`` of the nsforcing files.

    Files missing under ``data_root`` (``DATA_ROOT`` by default) are
    generated first, on ``device``, as the JAX loader generates them. The
    train loader shuffles from ``seed`` as the JAX loader does; ``kwargs``
    go to ``PTDataset``.
    """
    root = Path(data_root) if data_root else DATA_ROOT
    if not (root / f"nsforcing_train_{train_resolution}.pt").exists():
        generate_navier_stokes_files(root, n_train=max(n_train, 32),
                                     n_test=max(max(n_tests), 8), res=train_resolution,
                                     device=device)
    # test files at other resolutions are generated on demand, without train samples
    for res, n_t in zip(test_resolutions, n_tests):
        if not (root / f"nsforcing_test_{res}.pt").exists():
            generate_navier_stokes_files(root, n_train=0, n_test=max(n_t, 4), res=res,
                                         device=device)
    ds = PTDataset(
        root_dir=root, dataset_name="nsforcing", n_train=n_train, n_tests=n_tests,
        batch_size=batch_size, test_batch_sizes=test_batch_sizes,
        train_resolution=train_resolution, test_resolutions=list(test_resolutions),
        encode_input=encode_input, encode_output=encode_output, **kwargs,
    )
    train_loader = DataLoader(ds.train_db, batch_size, shuffle=True, seed=seed)
    test_loaders = {
        res: DataLoader(db, bs) for (res, db), bs in zip(ds.test_dbs.items(), test_batch_sizes)
    }
    return train_loader, test_loaders, ds.data_processor


class NavierStokesDataset(PTDataset):
    """``PTDataset`` over ``nsforcing_{train,test}_{res}.pt``, generating the
    files of every resolution that lacks one of them (on ``device``)."""

    def __init__(
        self,
        root_dir,
        n_train: int,
        n_tests: List[int],
        batch_size: int,
        test_batch_sizes: List[int],
        train_resolution: int = 128,
        test_resolutions: List[int] = (128,),
        encode_input: bool = True,
        encode_output: bool = True,
        encoding: str = "channel-wise",
        channel_dim: int = 1,
        *,
        device="cuda",
        **kwargs,
    ):
        root = Path(root_dir)
        missing = [
            res for res in sorted({train_resolution, *test_resolutions})
            if not (root / f"nsforcing_train_{res}.pt").exists()
            or not (root / f"nsforcing_test_{res}.pt").exists()
        ]
        for res in missing:
            generate_navier_stokes_files(root, n_train=max(n_train, 32),
                                         n_test=max(max(n_tests), 8), res=res, device=device)
        super().__init__(
            root_dir=root, dataset_name="nsforcing", n_train=n_train, n_tests=n_tests,
            batch_size=batch_size, test_batch_sizes=test_batch_sizes,
            train_resolution=train_resolution, test_resolutions=list(test_resolutions),
            encode_input=encode_input, encode_output=encode_output, encoding=encoding,
            channel_dim=channel_dim, **kwargs,
        )

