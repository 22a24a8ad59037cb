"""Rollout evaluation (and an optional pushforward fine-tune) on NS trajectories.

Port of ``scripts/eval_ns_rollout.py``. Evaluates a trained single-step NS
model autoregressively on held-out raw trajectories (the per-step relative
L2 at t = 1..horizon, from snapshot 10 of each of the first ``n_traj``
test trajectories), and optionally fine-tunes it with multi-step
pushforward training (``Trainer.train(rollout_steps=K, pushforward=True)``,
AdamW at ``learning_rate``, the H1 loss) on windows of the training
trajectories before scoring the rollout again. The trajectories are
``ns_raw/nsforcing_traj_{test,train}_{res}.npy`` under the loaders' data
root (``data/datasets/navier_stokes.DATA_ROOT``, written by
``generate_ns_data``) or ``--data_dir``.

Usage:
  python -m neuraloperator_tpu_torch.scripts.eval_ns_rollout \\
      --save_dir artifacts/ns128_v2 --save_name best_model_f16 --res 128 \\
      --horizon 10 [--pushforward_epochs 3 --rollout_steps 4] [--device cpu]
"""

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import DataLoader, TensorDataset, navier_stokes
from ..data.datasets.ns_solver import trajectories_to_windows
from ..losses import H1Loss, LpLoss
from ..training import Trainer, adamw, setup
from ._checkpoint_cli import checkpoint_processor, load_fno, split_device

# rollouts start mid-trajectory (on-attractor states), at this snapshot
T0 = 10


@dataclass
class RolloutConfig(ConfigBase):
    save_dir: str = "runs/ns128_flagship"
    save_name: str = "best_model"
    res: int = 128
    horizon: int = 10
    n_traj: int = 40
    batch: int = 8
    n_modes: int = 64
    hidden_channels: int = 64
    projection_channel_ratio: int = 4
    # pushforward fine-tune (0 epochs = eval only)
    pushforward_epochs: int = 0
    rollout_steps: int = 4
    learning_rate: float = 1e-4
    train_traj: int = 64
    verbose: bool = True
    # where ns_raw/ lies (the loaders' data root when None)
    data_dir: Optional[str] = None


@torch.inference_mode()
def per_step_rollout_l2(model, dp, x0, y_traj, batch: int, device="cuda") -> np.ndarray:
    """Relative L2 per rollout step, averaged over trajectories.

    ``x0`` (N, 1, n, n) and ``y_traj`` (N, T, 1, n, n) are arrays; each batch
    of ``batch`` trajectories (the last one ragged) is rolled out T steps,
    every prediction denormalized, scored and fed back as the next input.
    Returns the T means as float64.
    """
    device = resolve_device(device)
    l2 = LpLoss(d=2, reduction="mean")
    model.eval()
    totals = torch.zeros(y_traj.shape[1], dtype=torch.float64, device=device)
    n = 0
    for i in range(0, len(x0), batch):
        x = torch.tensor(x0[i:i + batch], device=device)
        y = torch.tensor(y_traj[i:i + batch], device=device)
        vals = []
        for t in range(y.shape[1]):
            sample = dp.preprocess({"x": x}, train=False)
            out, _ = dp.postprocess(model(sample["x"]), sample, train=False)
            vals.append(l2(out, y[:, t]))
            x = out
        # the batch's f32 means times its length, summed in float64
        totals += (torch.stack(vals) * len(y)).double()
        n += len(y)
    return (totals / n).cpu().numpy()


def _print_steps(title: str, steps) -> None:
    print(title)
    for t, v in enumerate(steps, 1):
        print(f"  t={t}: {v:.5f}")


def main(argv=None) -> dict:
    """Run the script on ``argv``; returns ``{"rollout_l2": per-step array}``
    and, after a pushforward fine-tune, its ``"pushforward_rollout_l2"``
    and the fine-tune's ``"pushforward_metrics"``."""
    device, argv = split_device(argv)
    config = make_config_from_cli(RolloutConfig, argv)
    device = resolve_device(device)
    setup()
    res = config.res
    dp = checkpoint_processor(config.save_dir, res, device)
    model = load_fno(config, device)

    data_dir = Path(config.data_dir or navier_stokes.DATA_ROOT) / "ns_raw"
    traj = np.load(data_dir / f"nsforcing_traj_test_{res}.npy", mmap_mode="r")
    traj = np.asarray(traj[:config.n_traj], np.float32)
    T = config.horizon
    x0 = traj[:, T0][:, None]  # (n, 1, res, res)
    y = traj[:, T0 + 1:T0 + 1 + T][:, :, None]  # (n, T, 1, res, res)

    steps = per_step_rollout_l2(model, dp, x0, y, config.batch, device)
    _print_steps("single-step-trained rollout rel-l2 per step:", steps)
    result = {"rollout_l2": steps}

    if config.pushforward_epochs > 0:
        train_traj = np.asarray(
            np.load(data_dir / f"nsforcing_traj_train_{res}.npy", mmap_mode="r")[
                :config.train_traj],
            np.float32,
        )
        xw, yw = trajectories_to_windows(train_traj, config.rollout_steps)
        if config.verbose:
            print(f"pushforward fine-tune on {len(xw)} windows (K={config.rollout_steps})")
        loader = DataLoader(TensorDataset(x=xw, y=yw), config.batch, shuffle=True,
                            drop_last=True)
        trainer = Trainer(model=model, n_epochs=config.pushforward_epochs, data_processor=dp,
                          verbose=config.verbose, eval_interval=10_000, device=device)
        result["pushforward_metrics"] = trainer.train(
            loader, {}, adamw(config.learning_rate), training_loss=H1Loss(d=2),
            rollout_steps=config.rollout_steps, pushforward=True,
        )
        result["pushforward_rollout_l2"] = per_step_rollout_l2(model, dp, x0, y, config.batch,
                                                               device)
        _print_steps("pushforward-tuned rollout rel-l2 per step:",
                     result["pushforward_rollout_l2"])
    return result


if __name__ == "__main__":
    main()
