"""Zero-shot super-resolution evaluation of a saved NS model (port of ``scripts/eval_ns_superres.py``).

Evaluates a trained (e.g. 128²-trained) FNO on single-step pairs built from
raw nsforcing test trajectories at other resolutions, under the checkpoint's
normalizers (channel-wise, so resolution-independent): the
discretization-invariance measurement. For each resolution it reads
``ns_raw/nsforcing_traj_test_{res}.npy`` under the loaders' data root
(``data/datasets/navier_stokes.DATA_ROOT``, where ``generate_ns_data --res
R --train-traj 0`` writes it) or ``--data_dir``, takes the first
``max_pairs`` consecutive-snapshot pairs, and scores them in batches of
``batch``, the last one ragged if need be. A missing file is reported and
skipped.

Usage:
  python -m neuraloperator_tpu_torch.scripts.eval_ns_superres \\
      --save_dir artifacts/ns128_v2 --save_name best_model_f16 \\
      --train_res 128 --eval_res '[128,256,512]' [--device cpu]
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import navier_stokes
from ..data.datasets.ns_solver import trajectories_to_pairs
from ..training import setup
from ._checkpoint_cli import checkpoint_processor, load_fno, split_device
from .eval_ns_checkpoint import evaluate


@dataclass
class SRConfig(ConfigBase):
    save_dir: str = "runs/ns128_flagship"
    save_name: str = "best_model"
    train_res: int = 128
    eval_res: List[int] = field(default_factory=lambda: [128, 256])
    max_pairs: int = 256
    batch: int = 8
    n_modes: int = 64
    hidden_channels: int = 64
    projection_channel_ratio: int = 4
    # where ns_raw/ lies (the loaders' data root when None)
    data_dir: Optional[str] = None


def load_pairs(path: Path, max_pairs: int):
    """The first ``max_pairs`` pairs w_t -> w_{t+1} of the trajectories in
    ``path``, as (N, 1, n, n) float32 arrays; only the trajectories they
    come from are read."""
    traj = np.load(path, mmap_mode="r")
    n_traj = -(-max_pairs // (traj.shape[1] - 1))
    xs, ys = trajectories_to_pairs(np.array(traj[:n_traj], np.float32))
    return xs[:max_pairs, None], ys[:max_pairs, None]


def main(argv=None) -> dict:
    """Run the script on ``argv``; returns ``{res: {"pairs", "rel_l2",
    "rel_h1"}}`` for each resolution evaluated."""
    device, argv = split_device(argv)
    config = make_config_from_cli(SRConfig, argv)
    device = resolve_device(device)
    setup()
    dp = checkpoint_processor(config.save_dir, config.train_res, device)
    model = load_fno(config, device)
    data_dir = Path(config.data_dir or navier_stokes.DATA_ROOT) / "ns_raw"
    figures = {}
    for res in config.eval_res:
        path = data_dir / f"nsforcing_traj_test_{res}.npy"
        if not path.exists():
            print(f"[{res}] missing {path.name} — generate with "
                  f"generate_ns_data.py --res {res} --train-traj 0")
            continue
        xs, ys = load_pairs(path, config.max_pairs)
        figures[res] = evaluate(model, dp, xs, ys, config.batch, device, drop_last=False)
        print(f"[{res}] pairs={figures[res]['pairs']} rel_l2={figures[res]['rel_l2']:.5f} "
              f"rel_h1={figures[res]['rel_h1']:.5f}", flush=True)
    return figures


if __name__ == "__main__":
    main()
