"""Per-mode complex channel contraction: the CUDA kernel and its plain version.

``out[b, o, m] = sum_i x[b, i, m] * w[i, o, m]`` with split real/imag
operands, in the model's natural layout (modes last and flattened). This
is the forward of the TPU kernel in
``neuraloperator_tpu/ops/pallas/spectral_contraction.py`` (``_kernel``
driven by ``_mode_contraction`` with ``_FWD``), whose operands were
transposed to (M, B, I) / (M, I, O) around the call; here they are not.

:func:`mode_contraction` launches ``csrc/spectral_contraction.cu`` for CUDA
tensors and runs :func:`mode_contraction_reference` for CPU tensors. The
kernel takes f32 or bf16 operands and returns f32.
"""

import ctypes
import functools
from typing import Tuple

import torch

from .. import _native

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _native.load_library("spectral_contraction")
    for suffix in _KERNEL_DTYPES.values():
        fn = getattr(lib, f"nop_mode_contraction_{suffix}")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.nop_error_string.argtypes = [ctypes.c_int]
    lib.nop_error_string.restype = ctypes.c_char_p
    return lib


def mode_contraction_reference(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, I, M), w (I, O, M) -> f32 (B, O, M) parts.

    Operands are widened to f32 first, so bf16 inputs give the products
    of their exact f32 values, summed in f32.
    """
    xr, xi, wr, wi = (t.float() for t in (xr, xi, wr, wi))
    eq = "bim,iom->bom"
    out_r = torch.einsum(eq, xr, wr) - torch.einsum(eq, xi, wi)
    out_i = torch.einsum(eq, xr, wi) + torch.einsum(eq, xi, wr)
    return out_r, out_i


def _check_operands(xr, xi, wr, wi) -> None:
    if not (xr.shape == xi.shape and wr.shape == wi.shape):
        raise ValueError(
            f"real and imaginary parts differ in shape: x {tuple(xr.shape)} "
            f"/ {tuple(xi.shape)}, w {tuple(wr.shape)} / {tuple(wi.shape)}"
        )
    if xr.ndim != 3 or wr.ndim != 3:
        raise ValueError(
            f"expected x (B, I, M) and w (I, O, M), got {tuple(xr.shape)} "
            f"and {tuple(wr.shape)}"
        )
    (_, i_x, m_x), (i_w, _, m_w) = xr.shape, wr.shape
    if i_x != i_w or m_x != m_w:
        raise ValueError(
            f"x {tuple(xr.shape)} and w {tuple(wr.shape)} disagree in the "
            "input channels or the modes"
        )
    dtypes = {t.dtype for t in (xr, xi, wr, wi)}
    if len(dtypes) != 1:
        raise TypeError(f"operands mix dtypes {sorted(map(str, dtypes))}")
    devices = {t.device for t in (xr, xi, wr, wi)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {devices}")


def mode_contraction(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, I, M), w (I, O, M) -> f32 (B, O, M) parts.

    On CUDA tensors this launches the kernel (and counts the launch in
    ``mode_contraction.launches``); on CPU tensors it runs the plain
    version. The kernel needs contiguous f32 or bf16 operands of one
    dtype on one card, and raises on anything else.
    """
    _check_operands(xr, xi, wr, wi)
    if xr.device.type == "cpu":
        return mode_contraction_reference(xr, xi, wr, wi)
    if xr.device.type != "cuda":
        raise ValueError(f"no kernel for device {xr.device}")
    suffix = _KERNEL_DTYPES.get(xr.dtype)
    if suffix is None:
        raise TypeError(
            f"the kernel takes float32 or bfloat16 operands, got {xr.dtype}"
        )
    for name, t in (("xr", xr), ("xi", xi), ("wr", wr), ("wi", wi)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, I, M = xr.shape
    O = wr.shape[1]
    out_r = torch.empty((B, O, M), dtype=torch.float32, device=xr.device)
    out_i = torch.empty_like(out_r)
    lib = _library()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        err = getattr(lib, f"nop_mode_contraction_{suffix}")(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            out_r.data_ptr(), out_i.data_ptr(), B, I, O, M, stream,
        )
    if err != 0:
        raise RuntimeError(
            "mode_contraction kernel launch failed: "
            f"{lib.nop_error_string(err).decode()} (cudaError {err})"
        )
    mode_contraction.launches += 1
    return out_r, out_i


mode_contraction.launches = 0
