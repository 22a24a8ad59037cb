"""Train an FNO-3D on MHD-64 next-step prediction (port of ``scripts/train_mhd64.py``).

The model predicts the next time step of three 3-D fields: the FNO at
n_modes (8, 8, 8), hidden 16, through ``get_model``; AdamW with StepLR
(lr 3e-4, every 20 epochs), H1 loss at ``d=3``, 5 epochs, batch 2. The data
are the script's own synthetic fields (``_synthetic_mhd``, a copy of the
JAX script's: band-limited 3-D vector fields and their spectrally diffused
next step) at 16³, 16 training and 4 test pairs. ``--data.well_base_path``
trains on the_well's MHD_64 there instead (``MHD64Dataset``, the "train"
and "valid" splits), through ``TheWellDataProcessor`` (one input step,
time as channels), the model's channels taken from the first item's
fields; without the ``the_well`` package it raises the wrappers'
``ImportError`` (the JAX script falls back to the synthetic fields; here a
run asked for real data does not train on synthetic ones, and the JAX
script hands the_well's items to its Trainer unformatted). The JAX script's
flags (``--section.key value``), plus ``--device`` (``cuda`` by default).
The weights are drawn from a generator seeded with 0.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_mhd64 [--opt.n_epochs 5] [--device cpu]
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, FNOModelConfig, OptConfig, make_config_from_cli
from ..data.datasets import DataLoader, MHD64Dataset, TensorDataset
from ..data.transforms import TheWellDataProcessor
from ..data.transforms.the_well_data_processors import _FIELD_KEYS
from ..losses import H1Loss, LpLoss
from ..models import get_model
from ..training import Trainer, adamw, setup, step_lr
from ..utils import count_model_params
from ._checkpoint_cli import split_device

SEED = 0


@dataclass
class MHDDataConfig(ConfigBase):
    well_base_path: str = ""
    batch_size: int = 2
    n_train: int = 16
    n_test: int = 4
    resolution: int = 16  # the synthetic fields' resolution (the real data: 64)


@dataclass
class MHDConfig(ConfigBase):
    model: FNOModelConfig = field(default_factory=lambda: FNOModelConfig(
        n_modes=[8, 8, 8], hidden_channels=16, out_channels=3, data_channels=3,
    ))
    opt: OptConfig = field(default_factory=lambda: OptConfig(
        n_epochs=5, learning_rate=3e-4, step_size=20
    ))
    data: MHDDataConfig = field(default_factory=MHDDataConfig)
    verbose: bool = True
    eval_interval: int = 1


def _wavenumbers(res: int) -> np.ndarray:
    """|k|² on the res³ grid."""
    k = np.fft.fftfreq(res, d=1.0 / res)
    KX, KY, KZ = np.meshgrid(k, k, k, indexing="ij")
    return KX ** 2 + KY ** 2 + KZ ** 2


def diffuse(u: np.ndarray) -> np.ndarray:
    """The synthetic fields' time step: each channel of ``u`` (c, res, res,
    res) diffused spectrally, exp(-0.05 |k|²) per mode."""
    decay = np.exp(-0.05 * _wavenumbers(u.shape[-1]))
    return np.stack([np.fft.ifftn(np.fft.fftn(u[c]) * decay).real for c in range(len(u))])


def _synthetic_mhd(n: int, res: int, seed: int = 0):
    """Band-limited 3-D vector fields advanced by a spectral diffusion step
    (:func:`diffuse`): (u_t -> u_{t+1}) pairs, float32."""
    rng = np.random.default_rng(seed)
    mask = np.sqrt(_wavenumbers(res)) <= res // 4
    xs, ys = [], []
    for _ in range(n):
        u = np.stack([
            np.fft.ifftn(
                (rng.standard_normal((res,) * 3) + 1j * rng.standard_normal((res,) * 3)) * mask
            ).real
            for _ in range(3)
        ])
        u /= np.abs(u).max() + 1e-8
        v = diffuse(u)
        xs.append(u.astype(np.float32))
        ys.append(v.astype(np.float32))
    return np.stack(xs), np.stack(ys)


class _Fields:
    """A the_well dataset's items cut to their field arrays."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[idx]
        return {k: item[k] for k in _FIELD_KEYS if k in item}


def load_mhd(config: MHDConfig):
    """(train loader, test loader, data processor): the_well's MHD_64 under
    ``--data.well_base_path`` (its ``ImportError`` without the_well), else
    the synthetic fields and no processor."""
    base, batch = config.data.well_base_path, config.data.batch_size
    if base:
        train_ds, test_ds = MHD64Dataset(base, "train"), MHD64Dataset(base, "valid")
        return (DataLoader(_Fields(train_ds), batch, shuffle=True),
                DataLoader(_Fields(test_ds), batch), TheWellDataProcessor())
    res = config.data.resolution
    xtr, ytr = _synthetic_mhd(config.data.n_train, res, seed=0)
    xte, yte = _synthetic_mhd(config.data.n_test, res, seed=1)
    return (DataLoader(TensorDataset(xtr, ytr), batch, shuffle=True),
            DataLoader(TensorDataset(xte, yte), batch), None)


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final metrics."""
    device, argv = split_device(argv)
    config = make_config_from_cli(MHDConfig, argv)
    device = resolve_device(device)
    setup(config)
    train_loader, test_loader, processor = load_mhd(config)
    if processor is not None:  # the channels the processor lays out
        item = train_loader.dataset[0]
        steps, channels = item["input_fields"].shape[0], item["input_fields"].shape[-1]
        constants = item["constant_fields"].shape[-1] if "constant_fields" in item else 0
        config.model.data_channels = steps * channels + constants
        config.model.out_channels = channels
    model = get_model(config.to_dict(), device=device,
                      generator=torch.Generator().manual_seed(SEED))
    optimizer = adamw(step_lr(config.opt.learning_rate, config.opt.step_size, config.opt.gamma,
                              len(train_loader)),
                      weight_decay=config.opt.weight_decay)
    h1, l2 = H1Loss(d=3), LpLoss(d=3, p=2)
    trainer = Trainer(model=model, n_epochs=config.opt.n_epochs, data_processor=processor,
                      eval_interval=config.eval_interval, verbose=config.verbose, device=device)
    metrics = trainer.train(train_loader, {"mhd": test_loader}, optimizer,
                            training_loss=h1 if config.opt.training_loss == "h1" else l2,
                            eval_losses={"h1": h1, "l2": l2})
    if config.verbose:
        print("final:", {k: round(v, 5) for k, v in metrics.items()})
        print("params:", count_model_params(trainer.model))
    return metrics


if __name__ == "__main__":
    main()
