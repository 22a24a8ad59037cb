"""Serve a saved model checkpoint through batch buckets.

Port of ``scripts/serve_model.py``. Loads either checkpoint layout:
``{name}_metadata.json`` with ``{name}_state_dict.msgpack``
(``models.save_checkpoint``), or the Trainer's ``{name}.msgpack`` with
its ``{name}_metadata.json`` sidecar. Builds a ``CompiledForward`` for the
batch buckets, with the checkpoint's saved normalizers baked in when it
has a ``data_processor.json``, reports each bucket's first-run seconds and
latency, and sends one ragged request through the bucket dispatcher.

Usage:
  python -m neuraloperator_tpu_torch.scripts.serve_model --ckpt_dir runs/mymodel \\
      --name model --shape '[1,128,128]' [--buckets '[1,8]'] [--bf16 true] [--device cuda]

``--bf16 true`` serves the weights cast to bfloat16 (requests stay f32).
``--export PATH`` also writes the served forward (its weights, bf16 under
``--bf16``, and the saved normalizers baked in, the batch symbolic) as a
``torch.export`` artifact that ``serving.load_exported`` runs.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from .._common import resolve_device
from ..data.transforms import load_data_processor
from ..models import from_checkpoint, load_checkpoint
from ..serving import CompiledForward, export_forward
from ..training import load_training_state


def _ints(raw: str):
    return [int(s) for s in raw.strip("[]() ").split(",") if s.strip()]


def _flag(raw: str) -> bool:
    return raw.lower() in ("1", "true", "yes")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt_dir", default="runs/model")
    p.add_argument("--name", default="model")
    p.add_argument("--shape", type=_ints, default=[1, 128, 128],
                   help="per-sample input shape (channels, *spatial)")
    p.add_argument("--buckets", type=_ints, default=[1, 8])
    p.add_argument("--bf16", type=_flag, default=False)
    p.add_argument("--export", default=None)
    p.add_argument("--probe_iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpt = Path(args.ckpt_dir)
    model = from_checkpoint(ckpt, args.name, device="meta").to_empty(device=device)
    if (ckpt / f"{args.name}_state_dict.msgpack").exists():
        load_checkpoint(model, ckpt, args.name)
    else:
        state, _, _ = load_training_state(ckpt, args.name, model.state_dict(), device=device)
        model.load_state_dict(state)

    # the training-time normalizers, baked in: requests flow raw-space in,
    # raw-space out
    dp = load_data_processor(ckpt)
    pre = post = None
    if dp is not None:
        if dp.in_normalizer is not None:
            pre = dp.in_normalizer.transform
        if dp.out_normalizer is not None:
            post = dp.out_normalizer.inverse_transform
        print("baked saved normalizers into the endpoint")

    example = torch.zeros((args.buckets[0], *args.shape))
    srv = CompiledForward(model, example, batch_sizes=args.buckets,
                          param_dtype=torch.bfloat16 if args.bf16 else None,
                          preprocess_fn=pre, postprocess_fn=post, device=device)
    print("compile seconds per bucket:",
          {b: round(s, 2) for b, s in srv.compile_seconds.items()})
    latency_ms = {}
    for b in srv.batch_sizes:
        lat = srv.latency_probe(b, iters=args.probe_iters)
        latency_ms[b] = 1e3 * lat
        print(f"bucket {b}: {lat * 1e3:.2f} ms/request ({b / lat:.1f} samples/s)")

    # a ragged request through the bucket dispatcher
    n = max(1, srv.batch_sizes[-1] - 1)
    out = srv(torch.from_numpy(np.random.RandomState(0).randn(n, *args.shape).astype(np.float32)))
    finite = bool(torch.isfinite(out).all())
    print(f"request({n}) -> {tuple(out.shape)}, finite: {finite}")
    result = {"compile_seconds": srv.compile_seconds, "latency_ms": latency_ms,
              "ragged": {"batch": n, "shape": tuple(out.shape), "finite": finite}}
    if args.export:
        # the served copy: its weights are the probed endpoint's (bf16 under --bf16)
        blob = export_forward(srv.model, example, path=args.export,
                              preprocess_fn=pre, postprocess_fn=post)
        print(f"exported {len(blob) / 1e6:.1f} MB -> {args.export}")
        result["export_mb"] = len(blob) / 1e6
    return result


if __name__ == "__main__":
    main()
