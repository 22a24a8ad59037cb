"""Physics-informed training of an FNO on Burgers (PINO; port of
``scripts/train_burgers_pino.py``).

A custom loop, not the ``Trainer``: the FNO at n_modes (8, 8), hidden 24,
4 layers maps the initial condition, repeated over time, to the space-time
solution on 16 x 16 (t, x) points. Its loss is the relative L2 to the
solution, the initial condition's MSE and the Burgers residual (visc 0.05,
domain [0, 1] x [0, 2 pi]), weighted by ReLoBRaLo (``--aggregator
softadapt`` for SoftAdapt), whose weights are updated once per epoch from
the epoch's last batch. AdamW at lr 1e-3 (no weight decay), batch 8, 30
epochs on 32 training pairs; then the test pairs' mean of the batches'
sum-reduced L2. The pairs are ``burgers_pino_{split}_{res}.pt`` under
``data/datasets/burgers.DATA_ROOT``, generated there by the seeded numpy
solver when missing. The weights are drawn from a generator seeded with
0. The JAX script's flags (``--key value``), plus ``--device`` (``cuda``
by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_burgers_pino [--n_epochs 30] \\
      [--aggregator softadapt] [--device cpu]
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import DataLoader, PTDataset
from ..data.datasets import burgers
from ..data.datasets.synthetic import generate_burgers_spacetime_files
from ..losses import BurgersEqnLoss, ICLoss, LpLoss, Relobralo, SoftAdapt
from ..models import FNO
from ..training import adamw, setup
from ._checkpoint_cli import split_device

SEED = 0


@dataclass
class PINOConfig(ConfigBase):
    n_train: int = 32
    n_test: int = 8
    batch_size: int = 8
    resolution: int = 16
    n_epochs: int = 30
    learning_rate: float = 1e-3
    visc: float = 0.05
    aggregator: str = "relobralo"  # or 'softadapt'
    verbose: bool = True


def build_model(*, device="cuda", generator=None) -> FNO:
    """The script's FNO on (t, x)."""
    return FNO(n_modes=(8, 8), in_channels=1, out_channels=1, hidden_channels=24, n_layers=4,
               device=device, generator=generator)


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    test figure, the last epoch's mean total loss, loss parts and weights."""
    device, argv = split_device(argv)
    config = make_config_from_cli(PINOConfig, argv)
    device = resolve_device(device)
    setup()
    root = burgers.DATA_ROOT
    if not (root / f"burgers_pino_train_{config.resolution}.pt").exists():
        generate_burgers_spacetime_files(
            root, n_train=max(config.n_train, 32), n_test=max(config.n_test, 8),
            res=config.resolution, visc=config.visc,
        )
    ds = PTDataset(
        root_dir=root,
        dataset_name="burgers_pino",
        n_train=config.n_train,
        n_tests=[config.n_test],
        batch_size=config.batch_size,
        test_batch_sizes=[config.batch_size],
        train_resolution=config.resolution,
        test_resolutions=[config.resolution],
        encode_input=False,
        encode_output=False,
    )
    train_loader = DataLoader(ds.train_db, config.batch_size, shuffle=True)
    test_loader = DataLoader(ds.test_dbs[config.resolution], config.batch_size)
    # the JAX script draws one batch to shape its init: its epochs see the
    # loader's next orders, and so do these
    next(iter(train_loader))

    model = build_model(device=device, generator=torch.Generator().manual_seed(SEED))
    opt = adamw(config.learning_rate).bind(model.named_parameters())
    data_loss = LpLoss(d=2)
    ic_loss = ICLoss()
    eqn_loss = BurgersEqnLoss(visc=config.visc, domain_length=[1.0, 2 * np.pi])
    agg_cls = Relobralo if config.aggregator == "relobralo" else SoftAdapt
    aggregator = agg_cls(num_losses=3)

    weights = torch.ones(3, device=device)
    for epoch in range(config.n_epochs):
        tot_avg, n = 0.0, 0
        for batch in train_loader:
            x = torch.from_numpy(batch["x"]).to(device)
            y = torch.from_numpy(batch["y"]).to(device)
            opt.zero_grad(set_to_none=True)
            out = model(x)
            parts = (data_loss(out, y), ic_loss(out, y), eqn_loss(out))
            tot = weights[0] * parts[0] + weights[1] * parts[1] + weights[2] * parts[2]
            tot.backward()
            opt.step()
            tot_avg += float(tot.detach())
            n += 1
        # the weights adapt once per epoch, from the last batch's parts
        parts = [p.detach() for p in parts]
        _, weights = aggregator({"data": parts[0], "ic": parts[1], "equation": parts[2]},
                                step=epoch)
        if config.verbose:
            print(
                f"[{epoch}] total={tot_avg / max(n, 1):.5f} "
                f"weights={np.round(weights.cpu().numpy(), 3).tolist()} "
                f"parts={[round(float(p), 5) for p in parts]}"
            )

    l2 = LpLoss(d=2)
    errs = []
    with torch.no_grad():
        for batch in test_loader:
            out = model(torch.from_numpy(batch["x"]).to(device))
            errs.append(float(l2(out, torch.from_numpy(batch["y"]).to(device))))
    test_l2 = float(np.mean(errs))
    print("test l2 (sum-reduced batches):", test_l2)
    return {"test_l2": test_l2, "total": tot_avg / max(n, 1),
            "parts": [float(p) for p in parts], "weights": weights.cpu().tolist()}


if __name__ == "__main__":
    main()
