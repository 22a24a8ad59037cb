"""Train FNOGNO on car-CFD surface pressure (port of
``scripts/train_fnogno_carcfd.py``).

The signed distance on a regular 16³ query grid is the gridded input; the
output GNO maps the latent FNO features to the pressure at the surface
vertices, one sample a step. The samples as in ``train_gino_carcfd``
(``--data_source synthetic`` or the default ``mini``, which the repository
does not ship). FNOGNO with radius 0.25 and 32 neighbours, the FNO at modes
(8, 8, 8), hidden 32, 4 layers; AdamW at lr 1e-3 (no weight decay) on the
relative L2 (``LpLoss(d=1)``); the mean test relative L2 every
``eval_interval`` epochs and at the end. The weights are drawn from a
generator seeded with 0. The JAX script's flags (``--key value``), plus
``--device`` (``cuda`` by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_fnogno_carcfd \\
      --data_source synthetic [--n_epochs 20] [--device cpu]
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..losses import LpLoss
from ..models import FNOGNO
from ..training import adamw, setup
from ._checkpoint_cli import split_device
from .train_gino_carcfd import load_samples

SEED = 0


@dataclass
class CarConfig(ConfigBase):
    n_epochs: int = 20
    learning_rate: float = 1e-3
    radius: float = 0.25
    max_neighbors: int = 32
    verbose: bool = True
    # 'mini': the reference's 3-sample mini_car.pt; 'synthetic': the
    # package's deformed-ellipsoid set at n_train/n_test scale
    data_source: str = "mini"
    n_train: int = 100
    n_test: int = 20
    eval_interval: int = 10


def build_model(config: CarConfig, *, device="cuda", generator=None) -> FNOGNO:
    """The script's FNOGNO."""
    return FNOGNO(in_channels=1, out_channels=1, gno_coord_dim=3, gno_radius=config.radius,
                  fno_n_modes=(8, 8, 8), fno_hidden_channels=32, fno_n_layers=4,
                  gno_max_neighbors=config.max_neighbors, gno_batched=False, device=device,
                  generator=generator)


def prep(sample, device):
    """(grid coordinates (n, n, n, 3), vertices (n_verts, 3), signed
    distance (n, n, n, 1), pressure (n_verts, 1)), the grid's bounding box
    scaled to the unit cube and the vertices with it."""
    qp = sample["query_points"].astype(np.float32)
    lo = qp.reshape(-1, 3).min(0)
    hi = qp.reshape(-1, 3).max(0)
    qp = (qp - lo) / (hi - lo + 1e-9)
    sdf = sample["distance"].astype(np.float32)
    verts = sample["vertices"].astype(np.float32)
    verts = (verts - lo) / (hi - lo + 1e-9)
    press = sample["press"].astype(np.float32).T
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (qp, verts, sdf, press))


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final test figure, each epoch's mean training loss and the evaluations."""
    device, argv = split_device(argv)
    config = make_config_from_cli(CarConfig, argv)
    device = resolve_device(device)
    setup()
    train, test = load_samples(config)
    batches = [prep(s, device) for s in train]
    test_batches = [prep(s, device) for s in test]
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(SEED))
    opt = adamw(config.learning_rate).bind(model.named_parameters())
    l2 = LpLoss(d=1)

    def loss_of(in_p, out_p, f, y):
        return l2(model(in_p, out_p, f).T[None], y.T[None])

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
