"""Batch-bucketed forward for serving (port of ``neuraloperator_tpu/serving.py``).

``CompiledForward`` keeps the JAX class's contract: a fixed set of batch
buckets, each request padded up to the smallest bucket that holds it and
the result sliced back, with the normalizers baked in around the model.
PyTorch runs eagerly, so a bucket is "compiled" by running it once at
construction (``compile_seconds``): that first run loads the kernels and
builds the DFT matrices on the device, so no request pays for them.
"""

import copy
import time
from typing import Callable, Optional, Sequence

import torch

from ._common import not_ported, resolve_device

__all__ = ["CompiledForward"]


def _round_up_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"request batch {n} exceeds the largest compiled bucket "
        f"{buckets[-1]}; construct CompiledForward with a larger "
        f"batch_sizes entry"
    )


class CompiledForward:
    """Batch-bucketed inference forward of a model.

    Parameters
    ----------
    model : ``torch.nn.Module`` holding its parameters. The served model is a
        copy of it made here, on ``device`` and in eval mode, as the JAX class
        serves the parameters it device-puts at construction: later changes
        to ``model`` (training it, editing its parameters) do not reach the
        answers, and ``model`` itself is left where it was, in the mode it
        was in. The copy costs one set of weights on ``device`` (277 MB for
        the f32 flagship FNO)
    example_input : tensor ``(b, ...)`` fixing every non-batch dim and the
        dtype every request is cast to
    batch_sizes : bucket list (default ``(1, 8)``), sorted ascending
    param_dtype : e.g. ``torch.bfloat16``: every floating parameter of the
        served copy is cast to it once, here. Requests keep the example's
        dtype, so an f32 request computes in f32 over the rounded weights
        (each layer works in the promoted dtype of its input and weights)
    preprocess_fn : applied to the padded input before the model (e.g.
        ``data_processor.in_normalizer.transform``)
    postprocess_fn : applied to the model output (e.g.
        ``data_processor.out_normalizer.inverse_transform``)
    device : ``"cuda"`` by default; raises without a card unless ``"cpu"``
    """

    def __init__(
        self,
        model: torch.nn.Module,
        example_input: torch.Tensor,
        batch_sizes: Sequence[int] = (1, 8),
        param_dtype=None,
        quantize: Optional[str] = None,
        preprocess_fn: Optional[Callable] = None,
        postprocess_fn: Optional[Callable] = None,
        mesh=None,
        *,
        device="cuda",
    ):
        if quantize is not None:
            raise not_ported("CompiledForward quantize", "quantize/export")
        if mesh is not None:
            raise not_ported("CompiledForward mesh", "the other families")
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device).eval()
        if param_dtype is not None:
            for p in self.model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(param_dtype)
        self.preprocess_fn = preprocess_fn
        self.postprocess_fn = postprocess_fn
        self.batch_sizes = tuple(sorted(int(b) for b in batch_sizes))
        self._feat_shape = tuple(example_input.shape[1:])
        self._dtype = example_input.dtype
        self.compile_seconds = {}
        for b in self.batch_sizes:
            t0 = time.perf_counter()
            self._forward(self._zeros(b))
            self._synchronize()
            self.compile_seconds[b] = time.perf_counter() - t0

    def _zeros(self, b: int) -> torch.Tensor:
        return torch.zeros((b,) + self._feat_shape, dtype=self._dtype, device=self.device)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.preprocess_fn is not None:
            x = self.preprocess_fn(x)
        out = self.model(x)
        if self.postprocess_fn is not None:
            out = self.postprocess_fn(out)
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Answer one request ``(n, ...)``; the result stays on ``device``."""
        x = torch.as_tensor(x).to(self.device, self._dtype)
        if tuple(x.shape[1:]) != self._feat_shape:
            raise ValueError(
                f"request of shape {tuple(x.shape)} does not fit the served "
                f"shape (n, {', '.join(map(str, self._feat_shape))})"
            )
        n = x.shape[0]
        b = _round_up_bucket(n, self.batch_sizes)
        if b != n:
            x = torch.cat([x, x.new_zeros((b - n,) + self._feat_shape)])
        out = self._forward(x)
        return out[:n] if out.ndim >= 1 and out.shape[0] == b else out

    def latency_probe(self, batch_size: Optional[int] = None, iters: int = 10) -> float:
        """Measured latency (s) per forward at one bucket.

        Each timed iteration ends in a device synchronize, so the number is
        the time until the answer exists, not the time to enqueue it.
        """
        if batch_size is None:
            b = self.batch_sizes[0]
        elif batch_size in self.batch_sizes:
            b = batch_size
        else:
            raise ValueError(
                f"batch_size {batch_size} is not a compiled bucket "
                f"{self.batch_sizes}; probe an exact bucket so the "
                f"latency is attributed to the right program"
            )
        x = self._zeros(b)
        self._forward(x)
        self._synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            self._forward(x)
            self._synchronize()
        return (time.perf_counter() - t0) / iters
