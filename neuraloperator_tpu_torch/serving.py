"""Serving: batch-bucketed forwards, int8 weights and portable artifacts
(port of ``neuraloperator_tpu/serving.py``).

``CompiledForward`` keeps the JAX class's contract: a fixed set of batch
buckets, each request padded up to the smallest bucket that holds it and
the result sliced back, with the normalizers baked in around the model.
PyTorch runs eagerly, so a bucket is "compiled" by running it once at
construction (``compile_seconds``): that first run loads the kernels and
builds the DFT matrices on the device, so no request pays for them.
``quantize="int8"`` keeps the large weights as per-row int8 codes and
scales (:func:`quantize_params_int8`) and dequantizes them to bfloat16 in
every forward, as the JAX class dequantizes inside each compiled program.

``export_forward`` serializes the forward, weights and normalizers baked
in, through ``torch.export`` (with a symbolic batch by default), and
``load_exported`` runs such an artifact without the model class or its
``state_dict``. Unlike the JAX artifact, it needs this package on the
serving host: its graph calls the contraction operators of
``ops/spectral_contraction.py``, one per spectral layer, which launch K1 on
the card, and loading the artifact imports that module. The artifact runs
with TF32 and bfloat16 reduced-precision reductions off for every matmul
(:func:`~.ops.fourier.dft_matmul_precision` around the call): the DFT
matmuls need them off and a graph cannot carry the switches, so the
channel-MLP matmuls run with them off too, whatever the loading process set.
"""

import copy
import io
import time
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ._common import resolve_device
from .parallel import mesh as mesh_lib
from .parallel.comm import all_gather_along
from .ops import spectral_contraction  # noqa: F401  (registers the operators an artifact calls)
from .ops.fourier import dft_matmul_precision

__all__ = [
    "CompiledForward",
    "dequantize_params",
    "export_forward",
    "load_exported",
    "quantize_params_int8",
]

# leaves smaller than this stay in full precision: biases and norm scales
# are a rounding error of the weight bytes but carry outsized numerical
# sensitivity (the JAX package's threshold)
_QUANT_MIN_SIZE = 4096

QuantizedState = Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]


def quantize_params_int8(state: Mapping[str, torch.Tensor]) -> QuantizedState:
    """Weight-only int8 quantization of a ``state_dict`` for serving.

    Each floating tensor with at least ``_QUANT_MIN_SIZE`` elements becomes
    ``(codes, scale)``: symmetric int8 codes per row over the last axis and
    the row's f32 absmax ``scale``, with the JAX package's order of
    operations (``round(a / scale * 127)``, half to even, clipped to
    +-127), so the codes equal its codes to the bit; the others become
    ``(tensor, None)``. The port keeps the JAX parameter layouts, so the
    rows are the same rows (the spectral weight's are its 33 last-axis modes).
    """
    def q(a: torch.Tensor):
        if not a.is_floating_point() or a.numel() < _QUANT_MIN_SIZE or a.ndim < 1:
            return a, None
        s = a.abs().amax(dim=-1, keepdim=True).float().clamp_min(1e-30)
        codes = torch.round(a.float() / s * 127.0).clamp(-127, 127).to(torch.int8)
        return codes, s

    return {name: q(a.detach()) for name, a in state.items()}


def dequantize_params(qstate: QuantizedState,
                      dequant_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params_int8`: ``(codes * (scale / 127))``
    in f32, then cast to ``dequant_dtype``; unquantized tensors as they are."""
    return {name: a if s is None else (a.float() * (s / 127.0)).to(dequant_dtype)
            for name, (a, s) in qstate.items()}


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
    quantize : ``"int8"`` keeps every large floating weight (after the
        ``param_dtype`` cast) as int8 codes and f32 scales on ``device``
        (:func:`quantize_params_int8`; 78 MB against 277 MB of f32 weights
        for the flagship FNO) and dequantizes them to bf16 in each forward
        (:func:`dequantize_params`), which runs the served module through
        ``torch.func.functional_call``. The served module then holds no
        weights of its own (its parameters lie on the meta device)
    preprocess_fn : applied to the padded input before the model (e.g.
        ``data_processor.in_normalizer.transform``)
    postprocess_fn : applied to the model output (e.g.
        ``data_processor.out_normalizer.inverse_transform``)
    mesh : a ``parallel.mesh.Mesh``: each rank answers its data rank's slice
        of every bucket and the answers are all-gathered over the data
        ranks, as the JAX class shards a bucket over the mesh's data axis
        (every bucket must divide by the data size)
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
        if quantize is not None and quantize != "int8":
            raise ValueError(f"unsupported quantize={quantize!r}")
        if mesh is not None:
            dp = mesh.shape[mesh_lib.DATA_AXIS]
            bad = [b for b in batch_sizes if b % dp]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the {dp} data ranks")
        self.mesh = mesh
        self.device = resolve_device(device)
        self._params = None
        if quantize is None:
            self.model = copy.deepcopy(model).to(self.device).eval()
            if param_dtype is not None:
                for p in self.model.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(param_dtype)
        else:
            # a copy without data: the int8 codes and scales are the only
            # weights kept on the device
            skeleton = {id(t): torch.nn.Parameter(torch.empty_like(t, device="meta"),
                                                  requires_grad=False)
                        for t in model.parameters()}
            self.model = copy.deepcopy(model, skeleton).eval()
            state = model.state_dict()
            if param_dtype is not None:
                state = {k: v.to(param_dtype) if v.is_floating_point() else v
                         for k, v in state.items()}
            self._params = {k: tuple(t if t is None else t.to(self.device) for t in pair)
                            for k, pair in quantize_params_int8(state).items()}
        self.preprocess_fn = preprocess_fn
        self.postprocess_fn = postprocess_fn
        self.batch_sizes = tuple(sorted(int(b) for b in batch_sizes))
        self._feat_shape = tuple(example_input.shape[1:])
        self._dtype = example_input.dtype
        self.compile_seconds = {}
        for b in self.batch_sizes:
            t0 = time.perf_counter()
            self._serve(self._zeros(b))
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
        if self._params is None:
            out = self.model(x)
        else:
            out = torch.func.functional_call(self.model, dequantize_params(self._params), (x,))
        if self.postprocess_fn is not None:
            out = self.postprocess_fn(out)
        return out

    def _serve(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of a whole bucket: with a mesh, this data rank's slice
        of it, the answers all-gathered over the data ranks."""
        if self.mesh is None:
            return self._forward(x)
        local = self._forward(x[mesh_lib.local_slice(len(x), self.mesh)])
        return all_gather_along(local, 0, self.mesh.data_group)

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
        out = self._serve(x)
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
        self._serve(x)
        self._synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            self._serve(x)
            self._synchronize()
        return (time.perf_counter() - t0) / iters


class _ServedForward(torch.nn.Module):
    """``postprocess_fn(model(preprocess_fn(x)))``, the module an artifact records."""

    def __init__(self, model, preprocess_fn, postprocess_fn):
        super().__init__()
        self.model = model
        self.preprocess_fn, self.postprocess_fn = preprocess_fn, postprocess_fn

    def forward(self, x):
        if self.preprocess_fn is not None:
            x = self.preprocess_fn(x)
        out = self.model(x)
        return self.postprocess_fn(out) if self.postprocess_fn is not None else out


_PLATFORMS = ("cuda", "cpu")


def export_forward(
    model: torch.nn.Module,
    example_input: torch.Tensor,
    path=None,
    polymorphic_batch: bool = True,
    platforms: Optional[Sequence[str]] = None,
    preprocess_fn: Optional[Callable] = None,
    postprocess_fn: Optional[Callable] = None,
) -> bytes:
    """Serialize the forward to a ``torch.export`` artifact; returns its bytes.

    The weights (a copy of ``model``'s, in their dtypes), the DFT matrices
    and the statistics ``preprocess_fn`` and ``postprocess_fn`` use are
    baked in. With ``polymorphic_batch`` the leading dim is symbolic (any
    batch runs; the trace uses a batch of 2, since torch specializes a
    batch of 1); without it the artifact takes ``example_input``'s shape
    only. ``platforms`` names the one device the artifact is made for,
    ``"cuda"`` or ``"cpu"`` (default: ``model``'s). The bytes are also
    written to ``path`` if given.
    """
    if platforms is None:
        device = next(model.parameters()).device
    else:
        platforms = tuple(platforms)
        if len(platforms) != 1 or platforms[0] not in _PLATFORMS:
            raise ValueError(f"platforms must name one of {_PLATFORMS}, got {platforms}")
        device = resolve_device(platforms[0])
    served = _ServedForward(copy.deepcopy(model).to(device).eval(), preprocess_fn,
                            postprocess_fn)
    feat_shape = tuple(example_input.shape[1:])
    batch = 2 if polymorphic_batch else example_input.shape[0]
    x = torch.zeros((batch,) + feat_shape, dtype=example_input.dtype, device=device)
    dynamic = ({0: torch.export.Dim("batch")},) if polymorphic_batch else None
    with torch.no_grad():
        # an eager run first builds the constants the trace bakes in (DFT
        # matrices, grid, normalizer statistics) as real tensors on the device
        served(x)
        program = torch.export.export(served, (x,), dynamic_shapes=dynamic, strict=False)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    blob = buffer.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def load_exported(path_or_bytes) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an :func:`export_forward` artifact: a callable of the input,
    run without autograd and with TF32 and bf16 reduced-precision
    reductions off (see the module's note)."""
    blob = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else Path(path_or_bytes).read_bytes())
    forward = torch.export.load(io.BytesIO(bytes(blob))).module()

    def call(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), dft_matmul_precision():
            return forward(x)

    return call
