"""Train GINO on car-CFD surface pressure (port of
``scripts/train_gino_carcfd.py``).

Point-cloud geometry -> latent-grid FNO -> pressure at the surface
vertices, in a custom loop of one sample a step (each mesh has its own
neighbourhoods, searched inside the model's call). The samples:
``--data_source synthetic``, the package's deformed-ellipsoid
potential-flow set (``data/datasets/synthetic_cfd.py``, 2048 vertices,
``n_train`` + ``n_test`` samples from seed 0), or the default ``mini``, the
reference's ``mini_car.pt`` (two to train, one to test), which the
repository does not ship (``load_mini_car`` raises without it). GINO with
in/out radius 0.25 and 32 neighbours on a 16³ latent grid, the FNO at modes
(8, 8, 8), hidden 32, 4 layers; AdamW at lr 1e-3 (no weight decay) on the
relative L2 (``LpLoss(d=1)``); the mean test relative L2 every
``eval_interval`` epochs and at the end. The weights are drawn from a
generator seeded with 0. The JAX script's flags (``--key value``), plus
``--device`` (``cuda`` by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_gino_carcfd \\
      --data_source synthetic [--n_epochs 20] [--device cpu]
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import load_mini_car, load_synthetic_cfd
from ..losses import LpLoss
from ..models import GINO
from ..training import adamw, setup
from ._checkpoint_cli import split_device

SEED = 0


@dataclass
class CarConfig(ConfigBase):
    n_epochs: int = 20
    learning_rate: float = 1e-3
    latent_n: int = 16
    radius: float = 0.25
    max_neighbors: int = 32
    verbose: bool = True
    # 'mini': the reference's 3-sample mini_car.pt; 'synthetic': the
    # package's deformed-ellipsoid set at n_train/n_test scale
    data_source: str = "mini"
    n_train: int = 100
    n_test: int = 20
    eval_interval: int = 10


def load_samples(config):
    """(train, test) lists of dict samples of numpy arrays."""
    if config.data_source == "synthetic":
        samples = load_synthetic_cfd(config.n_train + config.n_test)
        return samples[: config.n_train], samples[config.n_train:]
    samples = load_mini_car()
    return samples[:2], samples[2:]


def build_model(config: CarConfig, *, device="cuda", generator=None) -> GINO:
    """The script's GINO."""
    return GINO(in_channels=1, out_channels=1, fno_in_channels=1, gno_coord_dim=3,
                in_gno_radius=config.radius, out_gno_radius=config.radius,
                fno_n_modes=(8, 8, 8), fno_hidden_channels=32, fno_n_layers=4,
                gno_max_neighbors=config.max_neighbors, device=device, generator=generator)


def latent_queries(n: int) -> np.ndarray:
    """The latent grid (1, n, n, n, 3) over the unit cube."""
    axes = [np.linspace(0, 1, n)] * 3
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)[None].astype(np.float32)


def prep(sample, lq: np.ndarray, device):
    """(geometry, latent queries, output queries, features, pressure): the
    vertices scaled into the unit cube (1, n, 3), ones as the input
    feature (1, n, 1), the pressure (1, n, 1)."""
    verts = sample["vertices"].astype(np.float32)
    lo, hi = verts.min(0), verts.max(0)
    verts = (verts - lo) / (hi - lo + 1e-9)
    press = sample["press"].astype(np.float32)  # (1, n_verts)
    x = np.ones((1, len(verts), 1), np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (verts[None], lq, verts[None], x, press.T[None]))


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final test figure, each epoch's mean training loss and the evaluations."""
    device, argv = split_device(argv)
    config = make_config_from_cli(CarConfig, argv)
    device = resolve_device(device)
    setup()
    train, test = load_samples(config)
    lq = latent_queries(config.latent_n)
    batches = [prep(s, lq, device) for s in train]
    test_batches = [prep(s, lq, device) for s in test]
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(SEED))
    opt = adamw(config.learning_rate).bind(model.named_parameters())
    l2 = LpLoss(d=1)

    def loss_of(geom, lq_, oq, x, y):
        out = model(geom, lq_, oq, x)
        return l2(out.permute(0, 2, 1), y.permute(0, 2, 1))

    def eval_test() -> float:
        with torch.no_grad():
            return float(np.mean([float(loss_of(*b)) for b in test_batches]))

    train_l2, evals = [], {}
    for epoch in range(config.n_epochs):
        losses = []
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            loss = loss_of(*batch)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        train_l2.append(float(np.mean(losses)))
        if config.verbose:
            msg = f"[{epoch}] train l2 {train_l2[-1]:.5f}"
            if (epoch + 1) % config.eval_interval == 0:
                evals[epoch] = eval_test()
                msg += f" test l2 {evals[epoch]:.5f}"
            print(msg, flush=True)

    final = eval_test()
    print(f"final test l2: {final:.5f}")
    return {"test_l2": final, "train_l2": train_l2, "evals": evals}


if __name__ == "__main__":
    main()
