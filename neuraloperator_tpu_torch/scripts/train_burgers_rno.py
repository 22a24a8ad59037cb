"""Train an RNO on Burgers time series (port of ``scripts/train_burgers_rno.py``).

The model sees a window of past states (b, t, 1, x) and predicts the next
one. The data: trajectories of viscous Burgers (visc 0.05) at 32 points
from random sine series, ``window + 1`` frames over T=1 with 100 RK4 steps
a frame, made on the host by :func:`make_data` from
``np.random.default_rng(0)``; 32 training and 8 test windows. The RNO at
n_modes (8,), hidden 24, 2 layers; AdamW at lr 1e-3 (no weight decay),
batch 8, 20 epochs of relative L2, each epoch's order drawn from
``np.random.RandomState(0)`` (the JAX script draws it from numpy's global
state); then the test windows' mean relative L2. The weights are drawn
from a generator seeded with 0. The JAX script's flags (``--key
value``), plus ``--device`` (``cuda`` by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_burgers_rno [--n_epochs 20] \\
      [--device cpu]
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets.synthetic import solve_burgers_trajectory
from ..losses import LpLoss
from ..models import RNO
from ..training import adamw, setup
from ._checkpoint_cli import split_device

SEED = 0


@dataclass
class RNOConfig(ConfigBase):
    n_train: int = 32
    n_test: int = 8
    res: int = 32
    window: int = 4
    n_epochs: int = 20
    batch_size: int = 8
    learning_rate: float = 1e-3
    verbose: bool = True


def make_data(config: RNOConfig):
    """(x_train, y_train, x_test, y_test), float32: windows (n, window, 1,
    res) and the next frames (n, 1, res)."""
    rng = np.random.default_rng(0)
    grid = np.linspace(0, 2 * np.pi, config.res, endpoint=False)

    def make(n):
        xs, ys = [], []
        for _ in range(n):
            coef = rng.standard_normal(4) / np.arange(1, 5)
            u0 = sum(c * np.sin((k + 1) * grid) for k, c in enumerate(coef))
            # 100 steps a frame keep the explicit RK4 viscous term stable at res 32
            traj = solve_burgers_trajectory(u0, visc=0.05, nt=config.window + 1,
                                            steps_per_frame=100)
            xs.append(traj[: config.window][:, None])
            ys.append(traj[config.window][None])
        return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)

    return (*make(config.n_train), *make(config.n_test))


def build_model(*, device="cuda", generator=None) -> RNO:
    """The script's RNO."""
    return RNO(n_modes=(8,), in_channels=1, out_channels=1, hidden_channels=24, n_layers=2,
               device=device, generator=generator)


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    test figure and each epoch's mean training loss."""
    device, argv = split_device(argv)
    config = make_config_from_cli(RNOConfig, argv)
    device = resolve_device(device)
    setup()
    x_train, y_train, x_test, y_test = (torch.from_numpy(a).to(device)
                                        for a in make_data(config))
    model = build_model(device=device, generator=torch.Generator().manual_seed(SEED))
    opt = adamw(config.learning_rate).bind(model.named_parameters())
    l2 = LpLoss(d=1)
    orders = np.random.RandomState(0)

    bs = config.batch_size
    train_l2 = []
    for epoch in range(config.n_epochs):
        perm = torch.from_numpy(orders.permutation(len(x_train))).to(device)
        losses = []
        for i in range(0, len(x_train), bs):
            idx = perm[i:i + bs]
            opt.zero_grad(set_to_none=True)
            loss = l2(model(x_train[idx]), y_train[idx])
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        train_l2.append(float(np.mean(losses)))
        if config.verbose:
            print(f"[{epoch}] train l2 {train_l2[-1]:.5f}")

    with torch.no_grad():
        test_l2 = float(l2(model(x_test), y_test)) / len(x_test)
    print("test l2:", test_l2)
    return {"test_l2": test_l2, "train_l2": train_l2}


if __name__ == "__main__":
    main()
