"""Fourier-mode weight contractions, dense and factorized (port of
``neuraloperator_tpu/ops/contractions.py``).

The dense, non-separable contraction runs through ``ModeContraction``:
where the JAX package chose between a Pallas kernel and a packed einsum by
backend (``set_contraction_backend``), the port goes by the tensor's
device, CUDA tensors taking the CUDA kernels (K1 forward, K2 and K3
backward), CPU tensors their plain versions. The separable contraction is
elementwise; the CP, Tucker and TT contractions are the JAX package's
complex einsums over the factors (``complex_einsum``), XLA einsums there
and ``torch.einsum`` here. ``contract_block`` dispatches as the JAX
function does: the ``"reconstructed"`` implementation, or a dense weight,
rebuilds the weight (``to_tensor``) and takes the dense contraction.
A model-sharded layer (``parallel.mesh.shard_params``) passes its slice of
the out-channel factor with the spec's out dim cut to match, so each
contraction, dense or factorized, yields this rank's out channels alone.
"""

from typing import Optional

import torch

from ..tensor.factorized import FactorizationSpec, Params, to_tensor
from .complex_einsum import Parts, complex_einsum
from .spectral_contraction import ModeContraction

_SYMS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def contract_dense(x: Parts, weight: Parts, separable: bool = False,
                   compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """x (re, im) of (b, i, m...), weight (re, im) of (i, o, m...) -> f32 (b, o, m...).

    ``compute_dtype`` (``torch.bfloat16`` under the "half" and "mixed"
    block precisions) is the dtype both operands are cast to first, so the
    kernels run their bf16 variants and sum in f32, as the JAX
    ``contract_dense`` casts them. The modes are flattened into one
    trailing axis, which keeps the natural layout: no operand is transposed.

    Separable: the weight (i, m...) multiplies x elementwise, in the
    promoted dtype of the two and returned as f32; ``compute_dtype`` does
    not apply, as in the JAX function.
    """
    xr, xi = x
    wr, wi = weight
    if separable:
        wr, wi = wr[None], wi[None]
        return (xr * wr - xi * wi).float(), (xr * wi + xi * wr).float()
    if compute_dtype is not None:
        xr, xi, wr, wi = (t.to(compute_dtype) for t in (xr, xi, wr, wi))
    b, i, *modes = xr.shape
    o = wr.shape[1]
    if tuple(wr.shape) != (i, o, *modes):
        raise ValueError(
            f"weight {tuple(wr.shape)} does not fit x {tuple(xr.shape)}"
        )
    flat_x = [t.reshape(b, i, -1).contiguous() for t in (xr, xi)]
    flat_w = [t.reshape(i, o, -1).contiguous() for t in (wr, wi)]
    out_r, out_i = ModeContraction.apply(*flat_x, *flat_w)
    return out_r.reshape(b, o, *modes), out_i.reshape(b, o, *modes)


def contract_cp(x: Parts, params: Params, spec: FactorizationSpec, separable: bool = False,
                compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """CP contraction: the rank-summed product of per-dim factors."""
    order = x[0].ndim
    x_syms = _SYMS[:order]
    rank_sym = _SYMS[order]
    out_sym = _SYMS[order + 1]
    factors = [params[f"factor_{i}"] for i in range(spec.order)]
    if separable:
        out_syms = x_syms
        factor_syms = [x_syms[1] + rank_sym]  # in-channel factor only
    else:
        out_syms = x_syms[0] + out_sym + x_syms[2:]
        factor_syms = [x_syms[1] + rank_sym, out_sym + rank_sym]
    factor_syms += [s + rank_sym for s in x_syms[2:]]
    eq = f"{x_syms},{rank_sym},{','.join(factor_syms)}->{out_syms}"
    return complex_einsum(eq, x, params["lambdas"], *factors, compute_dtype=compute_dtype)


def contract_tucker(x: Parts, params: Params, spec: FactorizationSpec, separable: bool = False,
                    compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """Tucker contraction: the core with per-dim factor matrices."""
    order = x[0].ndim
    x_syms = _SYMS[:order]
    out_sym = _SYMS[order]
    factors = [params[f"factor_{i}"] for i in range(spec.order)]
    if separable:
        core_syms = _SYMS[order + 1: 2 * order]  # ndim-1 core dims
        out_syms = x_syms
        factor_syms = [xs + rs for xs, rs in zip(x_syms[1:], core_syms)]
    else:
        core_syms = _SYMS[order + 1: 2 * order + 1]
        out_syms = x_syms[0] + out_sym + x_syms[2:]
        factor_syms = [x_syms[1] + core_syms[0], out_sym + core_syms[1]]
        factor_syms += [xs + rs for xs, rs in zip(x_syms[2:], core_syms[2:])]
    eq = f"{x_syms},{core_syms},{','.join(factor_syms)}->{out_syms}"
    return complex_einsum(eq, x, params["core"], *factors, compute_dtype=compute_dtype)


def contract_tt(x: Parts, params: Params, spec: FactorizationSpec, separable: bool = False,
                compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """Tensor-train contraction: the chain of 3-way cores."""
    order = x[0].ndim
    x_syms = _SYMS[:order]
    factors = [params[f"factor_{i}"] for i in range(spec.order)]
    if separable:
        weight_syms = list(x_syms[1:])
        out_syms = x_syms
    else:
        out_sym = _SYMS[order]
        weight_syms = [x_syms[1], out_sym] + list(x_syms[2:])
        out_syms = x_syms[0] + out_sym + x_syms[2:]
    rank_syms = _SYMS[order + 1:]
    core_syms = [rank_syms[i] + s + rank_syms[i + 1] for i, s in enumerate(weight_syms)]
    eq = f"{x_syms},{','.join(core_syms)}->{out_syms}"
    return complex_einsum(eq, x, *factors, compute_dtype=compute_dtype)


_FACTORIZED = {"cp": contract_cp, "tucker": contract_tucker, "tt": contract_tt}


def contract_block(x: Parts, spec: FactorizationSpec, params: Params, separable: bool = False,
                   implementation: str = "reconstructed",
                   compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """Dispatch the mode contraction (the JAX ``contract_block``)."""
    if implementation == "reconstructed" or spec.kind == "dense":
        return contract_dense(x, to_tensor(spec, params), separable=separable,
                              compute_dtype=compute_dtype)
    if implementation != "factorized":
        raise ValueError(
            f"implementation must be 'reconstructed' or 'factorized', got {implementation}"
        )
    if spec.kind not in _FACTORIZED:
        raise ValueError(f"Unknown factorization kind {spec.kind}")
    return _FACTORIZED[spec.kind](x, params, spec, separable=separable,
                                  compute_dtype=compute_dtype)
