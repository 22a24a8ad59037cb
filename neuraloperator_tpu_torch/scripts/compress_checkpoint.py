"""Compress a msgpack checkpoint to bf16 or f16 storage, with an
eval-equivalence check (port of ``scripts/compress_checkpoint.py``).

1. reads ``<dir>/<name>.msgpack`` (the raw tree, no template needed),
2. casts every f32 leaf to ``--dtype`` (round to nearest even) and writes
   ``<dir>/<name>_<dtype>.msgpack`` with the port's writer (flax's layout),
3. unless ``--no-eval``, and when ``<name>_metadata.json`` is there, rebuilds
   the model from it and prints the relative l2 distance between its outputs
   under the f32 and the stored weights (each cast back to f32) on a seeded
   batch of ``--batch`` fields at ``--spatial``², computed on ``--device``
   (``cuda`` unless ``cpu`` is asked for).

Prints one JSON line: ``in_bytes``, ``out_bytes``, ``path`` and
``eval_rel_l2_<dtype>_vs_f32``, as the JAX script does.

Usage:
  python -m neuraloperator_tpu_torch.scripts.compress_checkpoint --dir DIR \\
      --name best_model --spatial 128 [--dtype f16] [--device cpu]
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .._common import resolve_device
from ..serialization import msgpack_restore, msgpack_serialize


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--name", default="best_model")
    p.add_argument("--spatial", type=int, default=128,
                   help="spatial resolution of the equivalence-check batch")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--no-eval", action="store_true",
                   help="cast only; skip the model-rebuild output check")
    p.add_argument("--dtype", default="bf16", choices=("bf16", "f16"),
                   help="storage dtype; f16 keeps 3 more mantissa bits")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    folder = Path(args.dir)
    raw = (folder / f"{args.name}.msgpack").read_bytes()
    tree = msgpack_restore(raw)

    def cast(leaf):
        if isinstance(leaf, np.ndarray) and leaf.dtype == np.float32:
            if args.dtype == "f16":
                return leaf.astype(np.float16)
            return torch.from_numpy(np.array(leaf)).to(torch.bfloat16)
        return leaf

    stored = _map(tree, cast)
    out_path = folder / f"{args.name}_{args.dtype}.msgpack"
    out_path.write_bytes(msgpack_serialize(stored))
    result = {"in_bytes": len(raw), "out_bytes": out_path.stat().st_size, "path": str(out_path)}

    meta_path = folder / f"{args.name}_metadata.json"
    if not args.no_eval and meta_path.exists():
        from ..convert import convert_flax_params
        from ..models import from_checkpoint

        model = from_checkpoint(folder, args.name, device=device).eval()
        meta = json.loads(meta_path.read_text())
        in_ch = meta["init_kwargs"].get("in_channels", 1)
        x = np.random.RandomState(0).randn(args.batch, in_ch, args.spatial, args.spatial)
        x = torch.from_numpy(x.astype(np.float32)).to(device)
        outs = []
        for params in (tree, stored):
            model.load_state_dict(convert_flax_params(params, model.state_dict(), device=device))
            with torch.no_grad():
                outs.append(model(x).float())
        y32, y16 = outs
        result[f"eval_rel_l2_{args.dtype}_vs_f32"] = float(
            torch.linalg.norm(y16 - y32) / torch.linalg.norm(y32))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
