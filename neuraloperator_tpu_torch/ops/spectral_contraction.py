"""Per-mode complex channel contractions: the CUDA kernels and their plain versions.

Three contractions with split real/imag operands, in the model's natural
layout (modes last and flattened), as the TPU kernel in
``neuraloperator_tpu/ops/pallas/spectral_contraction.py`` (``_kernel``
driven by ``_mode_contraction``) runs them with three sets of dimension
numbers:

* K1, :func:`mode_contraction` (``_FWD``, ``:67``), the forward:
  ``out[b, o, m] = sum_i x[b, i, m] * w[i, o, m]``;
* K2, :func:`mode_contraction_dx` (``_BWD_X`` with ``conj_b``, ``:68``):
  ``dx[b, i, m] = sum_o g[b, o, m] * conj(w[i, o, m])``;
* K3, :func:`mode_contraction_dw` (``_BWD_W`` with ``conj_a``, ``:69``):
  ``dw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m]``.

The TPU kernel's operands were transposed to mode-major blocks around the
call; here they are not. Each wrapper launches ``csrc/spectral_contraction.cu``
for CUDA tensors (counting the launch in ``<wrapper>.launches``, and by the
operands' dtype in ``<wrapper>.launches_by_dtype``) and runs
its plain version (``*_reference``) for CPU tensors. All three are bound by
the bytes of their weight-sized operand or result (see the source's note);
:func:`mode_contraction_plan` and :func:`mode_contraction_dw_plan` report
how the launchers run a shape.
The kernels take f32 or bf16 operands of one dtype and return f32.

:class:`ModeContraction` is the differentiable contraction: K1 forward,
K2 and K3 backward, with the dtype casts of the JAX ``_pallas_bwd``.
"""

import ctypes
import functools
from typing import Dict, Mapping, Tuple

import torch

from .. import _native

Parts = Tuple[torch.Tensor, torch.Tensor]

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRY_POINTS = ("nop_mode_contraction", "nop_mode_contraction_dx",
                 "nop_mode_contraction_dw")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _native.load_library("spectral_contraction")
    for name in _ENTRY_POINTS:
        for suffix in _KERNEL_DTYPES.values():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    lib.nop_mode_contraction_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.nop_mode_contraction_plan.restype = ctypes.c_int
    lib.nop_mode_contraction_dw_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nop_mode_contraction_dw_plan.restype = ctypes.c_int
    lib.nop_error_string.argtypes = [ctypes.c_int]
    lib.nop_error_string.restype = ctypes.c_char_p
    return lib


def _widen(*parts: torch.Tensor):
    return tuple(t.float() for t in parts)


def mode_contraction_reference(xr, xi, wr, wi) -> Parts:
    """Plain K1: x (B, I, M), w (I, O, M) -> f32 (B, O, M) parts.

    Operands are widened to f32 first, so bf16 inputs give the products
    of their exact f32 values, summed in f32.
    """
    xr, xi, wr, wi = _widen(xr, xi, wr, wi)
    eq = "bim,iom->bom"
    out_r = torch.einsum(eq, xr, wr) - torch.einsum(eq, xi, wi)
    out_i = torch.einsum(eq, xr, wi) + torch.einsum(eq, xi, wr)
    return out_r, out_i


def mode_contraction_dx_reference(gr, gi, wr, wi) -> Parts:
    """Plain K2: g (B, O, M), w (I, O, M) -> f32 dx (B, I, M) = g . conj(w) over o."""
    gr, gi, wr, wi = _widen(gr, gi, wr, wi)
    eq = "bom,iom->bim"
    dx_r = torch.einsum(eq, gr, wr) + torch.einsum(eq, gi, wi)
    dx_i = torch.einsum(eq, gi, wr) - torch.einsum(eq, gr, wi)
    return dx_r, dx_i


def mode_contraction_dw_reference(xr, xi, gr, gi) -> Parts:
    """Plain K3: x (B, I, M), g (B, O, M) -> f32 dw (I, O, M) = conj(x) . g over b."""
    xr, xi, gr, gi = _widen(xr, xi, gr, gi)
    eq = "bim,bom->iom"
    dw_r = torch.einsum(eq, xr, gr) + torch.einsum(eq, xi, gi)
    dw_i = torch.einsum(eq, xr, gi) - torch.einsum(eq, xi, gr)
    return dw_r, dw_i


def _check_parts(name: str, re: torch.Tensor, im: torch.Tensor) -> None:
    if re.shape != im.shape:
        raise ValueError(
            f"real and imaginary parts of {name} differ in shape: "
            f"{tuple(re.shape)} / {tuple(im.shape)}"
        )
    if re.ndim != 3:
        raise ValueError(f"{name} must be 3-d, got {tuple(re.shape)}")


def _check_common(*ts: torch.Tensor) -> None:
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1:
        raise TypeError(f"operands mix dtypes {sorted(map(str, dtypes))}")
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")


def _shapes(kind: str, a: Parts, b: Parts) -> Tuple[int, int, int, int]:
    """(B, I, O, M) of one contraction, raising on operands that disagree."""
    _check_parts("the first operand", *a)
    _check_parts("the second operand", *b)
    _check_common(*a, *b)
    sa, sb = tuple(a[0].shape), tuple(b[0].shape)
    if kind == "fwd":  # x (B, I, M), w (I, O, M)
        (B, I, M), (I2, O, M2) = sa, sb
        ok = I == I2 and M == M2
    elif kind == "dx":  # g (B, O, M), w (I, O, M)
        (B, O, M), (I, O2, M2) = sa, sb
        ok = O == O2 and M == M2
    else:  # dw: x (B, I, M), g (B, O, M)
        (B, I, M), (B2, O, M2) = sa, sb
        ok = B == B2 and M == M2
    if not ok:
        raise ValueError(f"{kind} contraction: operands {sa} and {sb} disagree")
    return B, I, O, M


def _launch(kind: str, a: Parts, b: Parts, out_shape, dims) -> Parts:
    """Launch one kernel on the operands' card; raise on anything it does not take."""
    dev = a[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    suffix = _KERNEL_DTYPES.get(a[0].dtype)
    if suffix is None:
        raise TypeError(f"the kernel takes float32 or bfloat16 operands, got {a[0].dtype}")
    for name, t in zip(("a_re", "a_im", "b_re", "b_im"), (*a, *b)):
        if not t.is_contiguous():
            raise ValueError(f"operand {name} must be contiguous")
    out_r = torch.empty(out_shape, dtype=torch.float32, device=dev)
    out_i = torch.empty_like(out_r)
    lib = _library()
    entry = {"fwd": "nop_mode_contraction", "dx": "nop_mode_contraction_dx",
             "dw": "nop_mode_contraction_dw"}[kind]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{entry}_{suffix}")(
            a[0].data_ptr(), a[1].data_ptr(), b[0].data_ptr(), b[1].data_ptr(),
            out_r.data_ptr(), out_i.data_ptr(), *dims, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{entry} kernel launch failed: "
            f"{lib.nop_error_string(err).decode()} (cudaError {err})"
        )
    return out_r, out_i


def mode_contraction(xr, xi, wr, wi) -> Parts:
    """K1: x (B, I, M), w (I, O, M) -> f32 (B, O, M) parts.

    On CUDA tensors this launches the kernel (and counts the launch in
    ``mode_contraction.launches``); on CPU tensors it runs the plain
    version. The kernel needs contiguous f32 or bf16 operands of one
    dtype on one card, and raises on anything else.
    """
    B, I, O, M = _shapes("fwd", (xr, xi), (wr, wi))
    if xr.device.type == "cpu":
        return mode_contraction_reference(xr, xi, wr, wi)
    out = _launch("fwd", (xr, xi), (wr, wi), (B, O, M), (B, I, O, M))
    _count(mode_contraction, xr.dtype)
    return out


def mode_contraction_dx(gr, gi, wr, wi) -> Parts:
    """K2: g (B, O, M), w (I, O, M) -> f32 dx (B, I, M) parts; as :func:`mode_contraction`."""
    B, I, O, M = _shapes("dx", (gr, gi), (wr, wi))
    if gr.device.type == "cpu":
        return mode_contraction_dx_reference(gr, gi, wr, wi)
    out = _launch("dx", (gr, gi), (wr, wi), (B, I, M), (B, I, O, M))
    _count(mode_contraction_dx, gr.dtype)
    return out


def mode_contraction_dw(xr, xi, gr, gi) -> Parts:
    """K3: x (B, I, M), g (B, O, M) -> f32 dw (I, O, M) parts; as :func:`mode_contraction`."""
    B, I, O, M = _shapes("dw", (xr, xi), (gr, gi))
    if xr.device.type == "cpu":
        return mode_contraction_dw_reference(xr, xi, gr, gi)
    out = _launch("dw", (xr, xi), (gr, gi), (I, O, M), (B, I, O, M))
    _count(mode_contraction_dw, xr.dtype)
    return out


def _plan(kind: str, a: Parts, b: Parts) -> Tuple[int, ...]:
    """The five numbers a kernel's plan entry point reports for these CUDA operands."""
    B, I, O, M = _shapes(kind, a, b)
    if a[0].device.type != "cuda":
        raise ValueError(f"no kernel for device {a[0].device}")
    if a[0].dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 operands, got {a[0].dtype}")
    # the launch also needs the outputs aligned; torch.empty's always are
    aligned = int(all(t.data_ptr() % 16 == 0 for t in (*a, *b)))
    bf16 = int(a[0].dtype == torch.bfloat16)
    out = (ctypes.c_int * 5)()
    lib = _library()
    with torch.cuda.device(a[0].device):
        if kind == "dw":
            err = lib.nop_mode_contraction_dw_plan(bf16, B, I, O, M, aligned, out)
        else:
            err = lib.nop_mode_contraction_plan(bf16, int(kind == "dx"), B, I, O, M, aligned, out)
    if err != 0:
        raise RuntimeError(f"{kind} plan failed: {lib.nop_error_string(err).decode()} (cudaError {err})")
    return tuple(out)


def mode_contraction_plan(ar, ai, wr, wi, dx: bool = False) -> dict:
    """How K1 (or, with ``dx``, K2 on g (B, O, M)) runs on these CUDA
    operands, as its launcher decides.

    ``batch_tile`` is the batch rows a block serves from one read of the
    weight (1, 8 or 16) and ``weight_reads`` how often each weight element
    is read (once up to 16 rows; past that once per tile, the repeats
    meant to hit L2); ``load`` is ``"tma"`` (TMA tensor loads, when every
    plane is 16-byte aligned and a row of M values is a multiple of 16
    bytes) or ``"element"``; then the dynamic shared memory, the work units
    and the blocks launched. Launches nothing.
    """
    tile, aligned, smem, units, grid = _plan("dx" if dx else "fwd", (ar, ai), (wr, wi))
    return {"batch_tile": tile, "weight_reads": -(-ar.shape[0] // tile),
            "load": "tma" if aligned else "element",
            "smem_bytes": smem, "units": units, "grid": grid}


def mode_contraction_dw_plan(xr, xi, gr, gi) -> dict:
    """How K3 runs on these CUDA operands, as its launcher decides.

    ``schedule`` is ``"resident"`` (each block keeps a mode tile's x and g
    slices in shared memory) or ``"streamed"`` (batch chunks through two
    stages); ``load`` is ``"cp.async"`` (16-byte asynchronous copies, when
    every plane is 16-byte aligned) or ``"element"``; then the dynamic
    shared memory, the work units and the blocks launched. Launches nothing.
    """
    resident, aligned, smem, units, grid = _plan("dw", (xr, xi), (gr, gi))
    return {"schedule": "resident" if resident else "streamed",
            "load": "cp.async" if aligned else "element",
            "smem_bytes": smem, "units": units, "grid": grid}


_COUNTED = (mode_contraction, mode_contraction_dx, mode_contraction_dw)
# the operand dtypes the kernels take, by the names the counts use
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def reset_launch_counts() -> None:
    """Set every wrapper's launch counts (total and by dtype) to 0."""
    for fn in _COUNTED:
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(_DTYPE_NAMES.values(), 0)


reset_launch_counts()


def _count(fn, dtype: torch.dtype) -> None:
    fn.launches += 1
    fn.launches_by_dtype[_DTYPE_NAMES[dtype]] += 1


def launch_counts(by_dtype: bool = False) -> Dict[str, object]:
    """Each kernel wrapper's launch count, by the wrapper's name; with
    ``by_dtype``, ``{name: {"float32": n, "bfloat16": n}}`` instead."""
    if by_dtype:
        return {fn.__name__: dict(fn.launches_by_dtype) for fn in _COUNTED}
    return {fn.__name__: fn.launches for fn in _COUNTED}


def add_launches(counts: Mapping[str, Mapping[str, int]]) -> None:
    """Add ``counts`` (``{name: {dtype name: n}}``, as ``launch_counts(by_dtype=True)``
    gives them) to the wrappers' counts, the totals included.

    A CUDA graph that holds these kernels launches them on every replay
    without calling the wrappers; its owner counts the replay here, and
    takes back what the wrappers counted while the graph was captured
    (capture runs no kernel).
    """
    for fn in _COUNTED:
        for dtype, n in counts.get(fn.__name__, {}).items():
            fn.launches += n
            fn.launches_by_dtype[dtype] += n


class ModeContraction(torch.autograd.Function):
    """Differentiable K1: x (B, I, M), w (I, O, M) parts -> f32 (B, O, M) parts.

    The backward is ``_pallas_bwd`` of the JAX package: K2 on the output
    gradient cast to w's dtype gives dx, cast back to x's dtype; K3 on the
    output gradient cast to x's dtype gives dw, cast back to w's dtype.
    Only the gradients autograd asks for are computed.
    """

    @staticmethod
    def forward(ctx, xr, xi, wr, wi):
        ctx.save_for_backward(xr, xi, wr, wi)
        return mode_contraction(xr, xi, wr, wi)

    @staticmethod
    def backward(ctx, gr, gi):
        xr, xi, wr, wi = ctx.saved_tensors
        need = ctx.needs_input_grad
        dxr = dxi = dwr = dwi = None
        if need[0] or need[1]:
            dxr, dxi = mode_contraction_dx(
                gr.to(wr.dtype).contiguous(), gi.to(wr.dtype).contiguous(), wr, wi
            )
            dxr, dxi = dxr.to(xr.dtype), dxi.to(xi.dtype)
        if need[2] or need[3]:
            dwr, dwi = mode_contraction_dw(
                xr, xi, gr.to(xr.dtype).contiguous(), gi.to(xr.dtype).contiguous()
            )
            dwr, dwi = dwr.to(wr.dtype), dwi.to(wi.dtype)
        return dxr, dxi, dwr, dwi
