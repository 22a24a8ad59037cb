"""Merge an extension Navier–Stokes training set into the canonical train file
(port of ``scripts/merge_ns_train_data.py``).

``nsforcing_train_{res}.pt`` under the data root (``navier_stokes.DATA_ROOT``,
the directory the loaders read) and the one in ``--ext-dir`` are
concatenated and shuffled with ``np.random.default_rng(--shuffle-seed)``, so
any ``n_train`` prefix spans both; the canonical file keeps its name
(written to a temporary name, then renamed). The same flags and the same
merged file as the JAX script.

Usage:
  python -m neuraloperator_tpu_torch.scripts.merge_ns_train_data --ext-dir DIR [--res 128]
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import navier_stokes


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ext-dir", required=True,
                   help="dir holding the extension nsforcing_train_{res}.pt")
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--shuffle-seed", type=int, default=777)
    args = p.parse_args(argv)

    base_path = Path(navier_stokes.DATA_ROOT) / f"nsforcing_train_{args.res}.pt"
    ext_path = Path(args.ext_dir) / f"nsforcing_train_{args.res}.pt"
    base = torch.load(base_path.as_posix(), weights_only=True)
    ext = torch.load(ext_path.as_posix(), weights_only=True)

    x = np.concatenate([base["x"].numpy(), ext["x"].numpy()])
    y = np.concatenate([base["y"].numpy(), ext["y"].numpy()])
    perm = np.random.default_rng(args.shuffle_seed).permutation(len(x))
    x, y = np.ascontiguousarray(x[perm]), np.ascontiguousarray(y[perm])

    tmp = base_path.with_suffix(".pt.tmp")
    torch.save({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, tmp.as_posix())
    tmp.rename(base_path)
    print(f"merged {len(base['x'])} + {len(ext['x'])} -> {len(x)} pairs at {base_path}")
    return base_path


if __name__ == "__main__":
    main()
