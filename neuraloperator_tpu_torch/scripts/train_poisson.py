"""Train FNOGNO on the nonlinear Poisson point clouds with a
physics-informed loss (port of ``scripts/train_poisson.py``).

The source samples at each cloud's points, averaged onto a 16 x 16 grid
over the unit square, are the FNO's input; the GNO answers at the cloud's
boundary and interior query points. The loss is the relative L2 on every
query, plus ``interior_weight`` times the Poisson interior residual at the
first ``n_physics_points`` interior queries (``PoissonInteriorLoss``: the
model differentiated twice with respect to its queries), when that weight
is positive. The data: ``NonlinearPoissonDataset`` (``n_train`` +
``n_test`` samples from seed 0); FNOGNO in 2-D with modes (8, 8), hidden
24, 3 layers, radius 0.2 and 16 neighbours; AdamW at lr 1e-3 (no weight
decay), one sample a step; then the relative L2 of each test sample. The
weights are drawn from a generator seeded with 0. The JAX script's flags
(``--key value``), plus ``--device`` (``cuda`` by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_poisson [--n_epochs 10] \\
      [--interior_weight 0.1] [--device cpu]
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import NonlinearPoissonDataset
from ..losses import LpLoss, PoissonInteriorLoss
from ..models import FNOGNO
from ..training import adamw, setup
from ._checkpoint_cli import split_device

SEED = 0
GRID_N = 16


@dataclass
class PoissonConfig(ConfigBase):
    n_train: int = 4
    n_test: int = 2
    n_epochs: int = 10
    learning_rate: float = 1e-3
    interior_weight: float = 0.0  # > 0 adds the physics loss
    n_physics_points: int = 32
    verbose: bool = True


def build_model(*, device="cuda", generator=None) -> FNOGNO:
    """The script's FNOGNO."""
    return FNOGNO(in_channels=1, out_channels=1, gno_coord_dim=2, gno_radius=0.2,
                  fno_n_modes=(8, 8), fno_hidden_channels=24, fno_n_layers=3,
                  gno_max_neighbors=16, gno_batched=False, device=device, generator=generator)


def grid_points(device) -> torch.Tensor:
    """The FNO's grid (16, 16, 2) over the unit square."""
    axes = [np.linspace(0, 1, GRID_N)] * 2
    return torch.from_numpy(
        np.stack(np.meshgrid(*axes, indexing="ij"), -1).astype(np.float32)).to(device)


def prep(sample, device):
    """(the source on the grid (16, 16, 1): the mean of the samples in each
    cell, queries (n, 2), solution (n, 1), interior source terms, the
    number of boundary points)."""
    pts = sample["input_geom"]
    f_vals = sample["x"][:, 0]
    f_grid = np.zeros((GRID_N, GRID_N, 1), np.float32)
    cnt = np.zeros((GRID_N, GRID_N, 1), np.float32)
    ij = np.clip((pts * (GRID_N - 1)).astype(int), 0, GRID_N - 1)
    for (i, j), v in zip(ij, f_vals):
        f_grid[i, j, 0] += v
        cnt[i, j, 0] += 1
    f_grid = f_grid / np.maximum(cnt, 1)
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (f_grid, sample["output_queries"], sample["y"],
                              sample["output_source_terms_domain"]))
    return (*tensors, int(sample["num_boundary"]))


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    test figures and each epoch's mean training loss."""
    device, argv = split_device(argv)
    config = make_config_from_cli(PoissonConfig, argv)
    device = resolve_device(device)
    setup()
    ds = NonlinearPoissonDataset(n_train=config.n_train, n_test=config.n_test)
    in_p = grid_points(device)
    model = build_model(device=device, generator=torch.Generator().manual_seed(SEED))
    interior_loss = PoissonInteriorLoss()
    l2 = LpLoss(d=1)
    batches = [prep(ds.train_data[i], device) for i in range(len(ds.train_data))]
    opt = adamw(config.learning_rate).bind(model.named_parameters())
    n_phys = config.n_physics_points

    def loss_of(f_grid, queries, y, src, nb):
        out = model(in_p, queries, f_grid)
        data = l2(out.T[None], y.T[None])
        if config.interior_weight > 0:
            phys = interior_loss(lambda q: model(in_p, q, f_grid)[:, 0],
                                 output_queries=queries[nb:nb + n_phys],
                                 output_source_terms_domain=src[:n_phys])
            return data + config.interior_weight * phys
        return data

    losses_by_epoch = []
    for epoch in range(config.n_epochs):
        losses = []
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            loss = loss_of(*batch)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        losses_by_epoch.append(float(np.mean(losses)))
        if config.verbose:
            print(f"[{epoch}] loss {losses_by_epoch[-1]:.5f}")

    test_l2 = []
    with torch.no_grad():
        for i in range(len(ds.test_data)):
            f_grid, queries, y, _, _ = prep(ds.test_data[i], device)
            out = model(in_p, queries, f_grid)
            test_l2.append(float(l2(out.T[None], y.T[None])))
            print("test l2:", test_l2[-1])
    return {"test_l2": test_l2, "train_loss": losses_by_epoch}


if __name__ == "__main__":
    main()
