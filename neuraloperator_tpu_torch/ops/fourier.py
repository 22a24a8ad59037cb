"""Fourier-domain mode truncation (port of ``neuraloperator_tpu/ops/fourier.py``).

Two realizations of one semantics, as in the JAX package:

1. **Truncated DFT matmuls.** Only ``kept << n`` frequencies survive a
   spectral convolution, so each axis transform is one ``(kept x n)`` DFT
   matmul and each inverse one ``(n_out x kept)`` matmul whose structure
   enforces the DC/Nyquist Hermitian constraint. These are plain large
   matmuls, left to ``torch.matmul`` as the JAX package left them to XLA.
2. **FFTs and corner slices** (complex data, and a last axis over 512
   points): the centered block of a shifted spectrum is two corner slices
   of the unshifted one, gathered and scattered by
   :func:`gather_center_modes` / :func:`scatter_center_modes` around
   ``torch.fft`` transforms (cuFFT on the card).

Operands are float32 or bfloat16, as in the JAX helpers: float32 products
are f32-accurate (the JAX ``Precision.HIGH``); bfloat16 operands meet the
matrix rounded to bfloat16, every product is summed in float32 and rounded
to bfloat16 once, and ``rdft_scatter_last`` returns the float32 sum of its
two products. Each matmul runs, forward and backward, inside
:func:`dft_matmul_precision`.

The matrices are built once per (n, kept, norm) in numpy (float64 maths,
stored as float32) and cached as tensors once per device and dtype, outside
inference mode so that serving and training can share them in one process.

``irfftn_pocketfft`` inverts a spectrum that is not Hermitian as pocketfft
(numpy, JAX on the CPU) does, on every device.
"""

import contextlib
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

_FORWARD_SCALE = {"forward": lambda n: 1.0 / n, "backward": lambda n: 1.0,
                  "ortho": lambda n: n ** -0.5}
_INVERSE_SCALE = {"forward": lambda n: 1.0, "backward": lambda n: 1.0 / n,
                  "ortho": lambda n: n ** -0.5}


def kept_mode_counts(kept: int, size: int) -> Tuple[int, int]:
    """Split ``kept`` centered modes into (negative, nonneg) frequency counts.

    After fftshift the 0-frequency sits at ``size // 2`` and the kept block
    is ``[center - kept//2, center + kept//2 + kept%2)``; in natural FFT
    order that is the last ``kept//2`` entries (negative frequencies) and
    the first ``kept//2 + kept%2`` (0 and positive).
    """
    kept = min(kept, size)
    neg = kept // 2
    pos = kept // 2 + kept % 2
    return neg, pos


@functools.lru_cache(maxsize=256)
def _dft_gather_np(n: int, kept: int, norm: str) -> np.ndarray:
    """(2, kept, n) real/imag centered-mode DFT matrix.

    Row k holds frequency f_k in the centered order [-neg..-1, 0..pos-1]:
    D[k, h] = scale * exp(-2i pi f_k h / n).
    """
    neg, pos = kept_mode_counts(kept, n)
    freqs = np.concatenate([np.arange(-neg, 0), np.arange(0, pos)])
    h = np.arange(n)
    d = np.exp(-2j * np.pi * freqs[:, None] * h[None, :] / n)
    d = d * _FORWARD_SCALE[norm](n)
    return np.stack([d.real, d.imag]).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _dft_scatter_np(n_out: int, kept: int, norm: str) -> np.ndarray:
    """(2, n_out, kept) inverse-DFT matrix embedding centered modes.

    Column k holds frequency k - neg (the centered order); equals the ifft
    of the block scattered into a zero spectrum of size ``n_out``.
    """
    neg = kept // 2
    pos = kept - neg
    freqs = np.concatenate([np.arange(-neg, 0), np.arange(0, pos)])
    h = np.arange(n_out)
    d = np.exp(2j * np.pi * h[:, None] * freqs[None, :] / n_out)
    d = d * _INVERSE_SCALE[norm](n_out)
    return np.stack([d.real, d.imag]).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _rdft_gather_np(n: int, kept: int, norm: str) -> np.ndarray:
    """(2, kept, n): real-input DFT onto the lowest ``kept`` rfft bins."""
    k = np.arange(kept)
    w = np.arange(n)
    ang = 2 * np.pi * k[:, None] * w[None, :] / n
    scale = _FORWARD_SCALE[norm](n)
    return np.stack(
        [np.cos(ang) * scale, -np.sin(ang) * scale]
    ).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _rdft_scatter_np(n_out: int, kept: int, norm: str) -> np.ndarray:
    """(2, n_out, kept): truncated inverse rfft as two real matmuls.

    ``y = A[0] @ cr + A[1] @ ci`` equals ``irfft(pad(c), n_out)`` for a
    half-spectrum whose DC (and Nyquist) imaginary parts are zero: bins
    other than DC/Nyquist are conjugate-doubled, and the imaginary columns
    of DC/Nyquist are zeroed, which enforces Hermitian symmetry.
    """
    k = np.arange(kept)
    w = np.arange(n_out)
    ang = 2 * np.pi * w[:, None] * k[None, :] / n_out
    weight = np.where(
        (k == 0) | ((n_out % 2 == 0) & (k == n_out // 2)), 1.0, 2.0
    )
    scale = _INVERSE_SCALE[norm](n_out)
    a_r = np.cos(ang) * weight[None, :] * scale
    a_i = -np.sin(ang) * weight[None, :] * scale
    a_i[:, 0] = 0.0
    if n_out % 2 == 0 and kept - 1 == n_out // 2:
        a_i[:, kept - 1] = 0.0
    return np.stack([a_r, a_i]).astype(np.float32)


_BUILDERS = {
    "dft_gather": _dft_gather_np,
    "dft_scatter": _dft_scatter_np,
    "rdft_gather": _rdft_gather_np,
    "rdft_scatter": _rdft_scatter_np,
}


@functools.lru_cache(maxsize=256)
def _matrix(kind: str, n: int, kept: int, norm: str, device: torch.device,
            dtype: torch.dtype = torch.float32, widen: bool = False) -> torch.Tensor:
    """One cached (2, rows, cols) matrix on ``device``, rounded to ``dtype``
    (and held in float32 again with ``widen``).

    Built outside inference mode whatever mode the caller is in: a matrix
    first built by a served forward (``torch.inference_mode``) would
    otherwise be an inference tensor, which a later training forward at the
    same sizes cannot save for its backward.
    """
    with torch.inference_mode(False):
        d = torch.from_numpy(_BUILDERS[kind](n, kept, norm)).to(device=device, dtype=dtype)
        return d.float() if widen else d


@contextlib.contextmanager
def dft_matmul_precision():
    """cuBLAS's switches for the DFT matmuls, restored to the caller's values on exit.

    TF32 is off, so float32 products are f32-accurate (the JAX package asks
    for ``Precision.HIGH`` on each DFT matmul, whatever the default), and
    bfloat16 products keep every partial sum in float32 (its
    ``preferred_element_type=float32``; cuBLAS may otherwise reduce split-K
    partials in bfloat16). Both switches are process-wide and read when a
    matmul is issued, a matmul captured into a CUDA graph included, so they
    are set around each product and put back after it: what
    ``training.setup(matmul_precision=...)`` chose holds everywhere else.
    """
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = False
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved


class _DftMatmul(torch.autograd.Function):
    """``d @ x`` (``left``) or ``x @ d`` for a constant matrix ``d``, inside
    :func:`dft_matmul_precision` forward and backward."""

    @staticmethod
    def forward(ctx, x, d, left: bool):
        ctx.save_for_backward(d)
        ctx.left = left
        with dft_matmul_precision():
            return torch.matmul(d, x) if left else torch.matmul(x, d)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        with dft_matmul_precision():
            gx = torch.matmul(d.mT, g) if ctx.left else torch.matmul(g, d.mT)
        return gx, None, None


def _axis_complex_matmul(xr, xi, d: torch.Tensor, axis: int):
    """Apply a complex (rows x n) matrix along ``axis`` of split-real x.

    Each of the four products comes out in x's dtype (rounded once from
    its float32 sum for bfloat16), and the two combinations are formed in
    that dtype, as in the JAX helper.
    """
    axis = axis % xr.ndim
    ar, ai = xr.movedim(axis, -2), xi.movedim(axis, -2)

    def mm(a, m):
        return _DftMatmul.apply(a, m, True)

    yr = mm(ar, d[0]) - mm(ai, d[1])
    yi = mm(ai, d[0]) + mm(ar, d[1])
    return yr.movedim(-2, axis), yi.movedim(-2, axis)


def dft_gather_axis(xr, xi, kept: int, axis: int, norm: str):
    """fft + centered gather along one axis as a truncated DFT matmul."""
    n = xr.shape[axis]
    d = _matrix("dft_gather", n, kept, norm, xr.device, xr.dtype)
    return _axis_complex_matmul(xr, xi, d, axis)


def dft_scatter_axis(xr, xi, n_out: int, axis: int, norm: str):
    """centered scatter + ifft along one axis as an inverse-DFT matmul."""
    kept = xr.shape[axis]
    d = _matrix("dft_scatter", n_out, kept, norm, xr.device, xr.dtype)
    return _axis_complex_matmul(xr, xi, d, axis)


def rdft_gather_last(x: torch.Tensor, kept: int, norm: str):
    """``rfft(x, dim=-1)[..., :kept]`` as two real matmuls, in x's dtype."""
    d = _matrix("rdft_gather", x.shape[-1], kept, norm, x.device, x.dtype)
    return _DftMatmul.apply(x, d[0].T, False), _DftMatmul.apply(x, d[1].T, False)


def rdft_scatter_last(cr, ci, n_out: int, norm: str) -> torch.Tensor:
    """Hermitian-enforced truncated inverse rfft along the last axis; float32.

    bfloat16 operands are widened to float32 (exactly), with the matrix's
    bfloat16 values, so each product is the float32 sum of exact products
    and the result their float32 sum, as the JAX helper returns it.
    """
    a = _matrix("rdft_scatter", n_out, cr.shape[-1], norm, cr.device, cr.dtype,
                widen=cr.dtype != torch.float32)
    return (_DftMatmul.apply(cr.float(), a[0].T, False)
            + _DftMatmul.apply(ci.float(), a[1].T, False))


def gather_center_modes(x: torch.Tensor, kept_modes: Sequence[int],
                        axes: Sequence[int]) -> torch.Tensor:
    """The centered-mode block of an *unshifted* spectrum.

    ``fftshift(x, axes)[..., center-neg:center+pos, ...]`` per axis without
    the roll: along each axis frequencies ``-neg..-1, 0..pos-1``, the order
    the weights index.
    """
    for kept, ax in zip(kept_modes, axes):
        size = x.shape[ax]
        neg, pos = kept_mode_counts(kept, size)
        if neg == 0 and pos >= size:
            continue
        parts = [x.narrow(ax, size - neg, neg)] if neg else []
        parts.append(x.narrow(ax, 0, pos))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)
    return x


def scatter_center_modes(block: torch.Tensor, out_sizes: Sequence[int],
                         axes: Sequence[int]) -> torch.Tensor:
    """Embed a centered-mode block into a zero spectrum (unshifted order).

    The inverse of :func:`gather_center_modes`: along each axis
    ``cat(block[neg:], zeros(size - kept), block[:neg])``.
    """
    x = block
    for size, ax in zip(out_sizes, axes):
        kept = x.shape[ax]
        neg = kept // 2
        if kept > size:
            raise ValueError(
                f"block has {kept} modes along axis {ax} but target size is {size}"
            )
        if neg == 0 and kept == size:
            continue
        zshape = list(x.shape)
        zshape[ax] = size - kept
        parts = [x.narrow(ax, neg, kept - neg)]
        if size > kept:
            parts.append(x.new_zeros(zshape))
        if neg:
            parts.append(x.narrow(ax, 0, neg))
        x = torch.cat(parts, dim=ax)
    return x


def scatter_low_modes_last(block: torch.Tensor, size: int, axis: int = -1) -> torch.Tensor:
    """Zero-pad the (rfft, unshifted) ``axis`` up to ``size`` low modes."""
    kept = block.shape[axis]
    if kept == size:
        return block
    axis = axis % block.ndim
    pad = [0, 0] * (block.ndim - 1 - axis) + [0, size - kept]
    return torch.nn.functional.pad(block, pad)



def irfft_hermitian(spectrum: torch.Tensor, out_sizes: Sequence[int], axes: Sequence[int],
                    norm: str = "forward", enforce_hermitian_symmetry: bool = True
                    ) -> torch.Tensor:
    """Inverse real FFT over ``axes`` to ``out_sizes``, the DC and (even
    size) Nyquist bins of the last axis made Hermitian first.

    The reference's order of operations: inverse FFTs over the earlier
    axes, the imaginary parts of those bins zeroed (the mask filled on the
    device, so a CUDA graph can capture it), then the inverse real FFT of
    the last axis. The JAX function symmetrizes the same bins in the
    frequency domain (:func:`hermitianize_parts`) and runs one ``irfftn``:
    the real part of an inverse FFT is the inverse FFT of the Hermitian
    part, so the two agree. Without ``enforce_hermitian_symmetry``, a plain
    ``irfftn``.
    """
    axes, out_sizes = list(axes), list(out_sizes)
    if not enforce_hermitian_symmetry:
        return torch.fft.irfftn(spectrum, s=out_sizes, dim=axes, norm=norm)
    if len(axes) > 1:
        spectrum = torch.fft.ifftn(spectrum, s=out_sizes[:-1], dim=axes[:-1], norm=norm)
    last = axes[-1] % spectrum.ndim
    n = out_sizes[-1]
    half = n // 2 + 1
    kept = min(half, spectrum.shape[last])
    re = scatter_low_modes_last(spectrum.real.narrow(last, 0, kept).float(), half, last)
    im = scatter_low_modes_last(spectrum.imag.narrow(last, 0, kept).float(), half, last)
    keep = torch.ones(half, dtype=torch.bool, device=im.device)
    keep[0] = False
    if n % 2 == 0:
        keep[half - 1] = False
    im = torch.where(keep.reshape([half if d == last else 1 for d in range(im.ndim)]), im, 0.0)
    return torch.fft.irfft(torch.complex(re, im), n=n, dim=last, norm=norm)


def _reverse_frequencies(a: torch.Tensor, axis: int) -> torch.Tensor:
    """The frequency reversal k -> -k mod n along ``axis``."""
    n = a.shape[axis]
    return torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 1, n - 1).flip(axis)], dim=axis)


def hermitianize_parts(re: torch.Tensor, im: torch.Tensor, out_sizes: Sequence[int],
                       axes: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DC and (even size, when the last axis holds ``n // 2 + 1`` bins)
    Nyquist bins of the last axis made Hermitian along the earlier axes, in
    split-real form: each such column becomes ``(c + conj(c reversed)) / 2``.
    The JAX package's frequency-domain form of :func:`irfft_hermitian`'s
    constraint."""
    n_last, last = out_sizes[-1], axes[-1] % re.ndim
    h = re.shape[last]
    fix_bins = [0]
    if n_last % 2 == 0 and h == n_last // 2 + 1:
        fix_bins.append(h - 1)
    for b in fix_bins:
        col_r, col_i = re.narrow(last, b, 1), im.narrow(last, b, 1)
        rev_r, rev_i = col_r, col_i
        for ax in axes[:-1]:
            rev_r, rev_i = _reverse_frequencies(rev_r, ax), _reverse_frequencies(rev_i, ax)
        sym_r, sym_i = 0.5 * (col_r + rev_r), 0.5 * (col_i - rev_i)
        re = torch.cat([re.narrow(last, 0, b), sym_r, re.narrow(last, b + 1, h - b - 1)], last)
        im = torch.cat([im.narrow(last, 0, b), sym_i, im.narrow(last, b + 1, h - b - 1)], last)
    return re, im

def resolve_weight_slices(
    fft_size: Sequence[int],
    n_modes: Sequence[int],
    max_n_modes: Sequence[int],
    separable: bool,
    complex_data: bool,
) -> Tuple[slice, ...]:
    """Slices selecting the active centered modes of the full weight tensor.

    When ``n_modes < max_n_modes`` the kept modes sit at the *center* of
    the weight along each shifted dim and at the *start* along the rfft'd
    last dim. The slices index the weight's ``(in, out, modes...)`` dims
    (``(in, modes...)`` when separable).
    """
    starts = [
        max_m - min(size, n_mode)
        for (size, n_mode, max_m) in zip(fft_size, n_modes, max_n_modes)
    ]
    slices_w: List[slice] = [slice(None)] if separable else [slice(None)] * 2
    if complex_data:
        slices_w += [_center_slice(start) for start in starts]
    else:
        slices_w += [_center_slice(start) for start in starts[:-1]]
        slices_w += [slice(None, -starts[-1]) if starts[-1] else slice(None)]
    return tuple(slices_w)


def _center_slice(start: int) -> slice:
    """``slice(start//2, -start//2)`` with Python floor division.

    For odd ``start`` the extra removed entry comes off the *end*
    (start=3 -> slice(1, -2)).
    """
    if not start:
        return slice(None)
    return slice(start // 2, -start // 2)


def reference_weight_slice(start: int, is_last_real: bool) -> slice:
    """:func:`resolve_weight_slices` for one axis: the last real axis keeps
    its low modes, any other its centred ones."""
    if is_last_real:
        return slice(None, -start) if start else slice(None)
    return _center_slice(start)


def irfftn_pocketfft(spec: torch.Tensor, s: Sequence[int], norm: str = "backward") -> torch.Tensor:
    """``numpy.fft.irfftn(spec, s, norm=norm)`` over the last ``len(s)`` axes, for a
    spectrum that is not Hermitian, where ``spec`` already has the sizes
    ``s[:-1]`` and ``s[-1] // 2 + 1``: what pocketfft computes, on every
    device. The leading axes are inverted by a complex ``ifftn``, then the
    last by ``irfft`` with the imaginary parts of its DC and (even sizes)
    Nyquist terms dropped, as pocketfft's real transform drops them (cuFFT's
    multi-dimensional C2R assumes Hermitian input and would not)."""
    n = len(s)
    if n > 1:
        spec = torch.fft.ifftn(spec, dim=tuple(range(-n, -1)), norm=norm)
    half = s[-1] // 2 + 1
    keep = torch.ones(half, dtype=torch.bool, device=spec.device)
    keep[0] = False
    if s[-1] % 2 == 0:
        keep[half - 1] = False
    spec = torch.complex(spec.real, torch.where(keep, spec.imag, 0.0))
    return torch.fft.irfft(spec, n=s[-1], dim=-1, norm=norm)
