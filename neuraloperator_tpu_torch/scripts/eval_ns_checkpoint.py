"""Evaluate a saved Navier–Stokes checkpoint on its test split.

Port of ``scripts/eval_ns_checkpoint.py``: the relative L2 and H1 errors at
the test resolution, the same measurement the Trainer logs during training,
reproducible standalone. The architecture comes from the directory's
``model_metadata.json``, the weights from ``{save_name}.msgpack`` (a float16
copy is evaluated in float32), the normalizers from its
``data_processor.json`` or from ``--normalizer_from``'s.

The test split is ``nsforcing_test_{res}.pt`` under ``--data_dir`` when it
exists. Otherwise it is regenerated in memory by the seeded solver, as
``scripts/generate_ns_data.py`` makes it (40 trajectories, seed 10 000):
nothing is written.

Usage:
  python -m neuraloperator_tpu_torch.scripts.eval_ns_checkpoint \\
      --save_dir artifacts/ns128_v2 [--save_name best_model] [--res 128] \\
      [--n_test 2000] [--batch 16] [--normalizer_from artifacts/ns128_v3] \\
      [--data_dir DIR] [--device cuda]
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from .._common import resolve_device
from ..data.datasets import load_pt_as_numpy
from ..data.datasets.ns_solver import make_nsforcing_split
from ..data.transforms import load_data_processor
from ..losses import H1Loss, LpLoss
from ..models import load_flagship

# where scripts/generate_ns_data.py writes its splits
DATA_DIR = Path(__file__).resolve().parents[2] / "neuraloperator_tpu/data/datasets/data"
# its test split: seed 0 + 10_000, 40 trajectories of its default solver settings
TEST_SEED = 10_000
TEST_TRAJECTORIES = 40
SOLVER = dict(visc=1e-3, T=50.0, dt=1e-3, record_dt=1.0)


@torch.inference_mode()
def evaluate(model, processor, xs, ys, batch: int, device="cuda") -> dict:
    """Mean relative L2 and H1 error of ``model`` on the pairs ``(xs, ys)``.

    ``xs`` and ``ys`` are (N, 1, n, n) float32 arrays; ``model`` sits on
    ``device``. Each batch of ``batch`` pairs is normalized by
    ``processor.preprocess(train=False)``, run, and denormalized by
    ``processor.postprocess``; its ``reduction="mean"`` losses are weighted
    by its length. A ragged tail is dropped. Returns ``{"pairs",
    "rel_l2", "rel_h1"}``.
    """
    device = resolve_device(device)
    l2, h1 = LpLoss(d=2, reduction="mean"), H1Loss(d=2, reduction="mean")
    tot_l2 = tot_h1 = torch.zeros((), dtype=torch.float64, device=device)
    n = 0
    for i in range(0, len(xs) - batch + 1, batch):
        x = torch.as_tensor(xs[i:i + batch]).to(device)
        y = torch.as_tensor(ys[i:i + batch]).to(device)
        sample = processor.preprocess({"x": x}, train=False)
        out, _ = processor.postprocess(model(sample["x"]), sample, train=False)
        # python-float sums of the JAX script, in float64 on the device
        tot_l2 = tot_l2 + l2(out, y).double() * len(x)
        tot_h1 = tot_h1 + h1(out, y).double() * len(x)
        n += len(x)
    if not n:
        raise ValueError(f"{len(xs)} pairs hold no whole batch of {batch}")
    return {"pairs": n, "rel_l2": float(tot_l2) / n, "rel_h1": float(tot_h1) / n}


def load_test_split(res: int, n_test: int, data_dir=DATA_DIR, device="cuda"):
    """The first ``n_test`` test pairs at ``res``, as (N, 1, res, res) arrays."""
    test_pt = Path(data_dir) / f"nsforcing_test_{res}.pt"
    if test_pt.exists():
        data = load_pt_as_numpy(test_pt)
        xs, ys = data["x"], data["y"]
    else:
        print(f"{test_pt.name} missing — regenerating the test split in memory "
              "(seeded solver, deterministic)", flush=True)
        xs, ys = make_nsforcing_split(TEST_TRAJECTORIES, res, TEST_SEED, device=device, **SOLVER)
    return (np.asarray(xs, np.float32)[:n_test, None],
            np.asarray(ys, np.float32)[:n_test, None])


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save_dir", default="artifacts/ns128_v2")
    p.add_argument("--save_name", default="best_model")
    p.add_argument("--normalizer_from", default=None,
                   help="evaluate under another checkpoint's data_processor.json")
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--n_test", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--data_dir", default=str(DATA_DIR),
                   help="where nsforcing_test_{res}.pt is looked for")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    dp_dir = args.normalizer_from or args.save_dir
    dp = load_data_processor(dp_dir)
    if dp is None:
        raise SystemExit(f"no data_processor.json under {dp_dir}")
    print(f"normalizers from {dp_dir} (in std={np.ravel(dp.in_normalizer.std)})")
    model, _, _ = load_flagship(args.save_dir, args.save_name, device=device)
    xs, ys = load_test_split(args.res, args.n_test, args.data_dir, device)
    result = evaluate(model, dp, xs, ys, args.batch, device)
    print(
        f"{args.save_dir}/{args.save_name} @ {args.res}: pairs={result['pairs']} "
        f"rel_l2={result['rel_l2']:.6f} rel_h1={result['rel_h1']:.6f}",
        flush=True,
    )
    return result


if __name__ == "__main__":
    main()
