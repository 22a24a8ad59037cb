"""Generate the flagship's Navier–Stokes (nsforcing) splits on the card.

Port of ``scripts/generate_ns_data.py``: forced 2-D Navier–Stokes vorticity
trajectories (visc 1e-3, T = 50, a snapshot every 1.0 time unit, GRF(2.5, 7)
initial fields) from the batched solver of ``data/datasets/ns_solver.py``.
For each split it writes, under the JAX package's data directory (the
loaders' default root) or ``--out``:

- ``ns_raw/nsforcing_traj_{split}_{res}.npy``: the raw trajectories
  (n_traj, n_snap, res, res);
- ``nsforcing_{split}_{res}.pt``: the single-step pairs w_t -> w_{t+1},
  shuffled by ``default_rng(seed + 1)``, the layout ``PTDataset`` reads.

The train split is drawn from ``--seed``, the test split from
``--seed + 10_000``: with the defaults, the evaluation's split.

Usage:
  python -m neuraloperator_tpu_torch.scripts.generate_ns_data --res 128 \\
      --train-traj 200 --test-traj 40 [--out DIR] [--device cuda]
"""

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .._common import resolve_device
from ..data.datasets import navier_stokes
from ..data.datasets.ns_solver import generate_nsforcing_trajectories, trajectories_to_pairs

# the test split's seed offset
TEST_SEED_OFFSET = 10_000


def stream_split(out_dir: Path, split: str, n_traj: int, res: int, args, seed: int,
                 device) -> Path:
    """Solve one split block by block into its ``.npy``, then write its pairs."""
    n_snap = int(round(args.T / args.record_dt)) + 1
    raw_dir = out_dir / "ns_raw"
    raw_dir.mkdir(parents=True, exist_ok=True)
    traj_mm = np.lib.format.open_memmap(
        raw_dir / f"nsforcing_traj_{split}_{res}.npy", mode="w+", dtype=np.float32,
        shape=(n_traj, n_snap, res, res),
    )
    done = 0
    t0 = time.time()
    for block in generate_nsforcing_trajectories(
        n_traj, res, visc=args.visc, T=args.T, dt=args.dt, record_dt=args.record_dt,
        seed=seed, batch=args.batch, device=device,
    ):
        if np.isnan(block).any():
            raise RuntimeError(f"NaN in trajectory block at {done}")
        traj_mm[done:done + block.shape[0]] = block
        traj_mm.flush()
        done += block.shape[0]
        print(f"[{split}] {done}/{n_traj} trajectories ({time.time() - t0:.0f}s, "
              f"max|w|={np.abs(block).max():.2f})", flush=True)
    xs, ys = trajectories_to_pairs(np.asarray(traj_mm))
    # shuffled, so that any n_train prefix spans many trajectories
    perm = np.random.default_rng(seed + 1).permutation(len(xs))
    xs, ys = np.ascontiguousarray(xs[perm]), np.ascontiguousarray(ys[perm])
    path = out_dir / f"nsforcing_{split}_{res}.pt"
    torch.save({"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}, path.as_posix())
    print(f"[{split}] wrote {xs.shape[0]} pairs -> {path.name}", flush=True)
    return path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--train-traj", type=int, default=200)
    p.add_argument("--test-traj", type=int, default=40)
    p.add_argument("--visc", type=float, default=1e-3)
    p.add_argument("--T", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--record-dt", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    """Generate the splits asked for; returns ``{split: path of its .pt}``."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    out_dir = Path(args.out) if args.out else navier_stokes.DATA_ROOT
    written = {}
    if args.train_traj > 0:
        written["train"] = stream_split(out_dir, "train", args.train_traj, args.res, args,
                                        seed=args.seed, device=device)
    if args.test_traj > 0:
        written["test"] = stream_split(out_dir, "test", args.test_traj, args.res, args,
                                       seed=args.seed + TEST_SEED_OFFSET, device=device)
    return written


if __name__ == "__main__":
    main()
