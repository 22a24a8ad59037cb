"""Factorized complex weight tensors: Dense, CP, Tucker and TT (port of
``neuraloperator_tpu/tensor/factorized.py``).

A factorized weight is a dict of factors plus a static
:class:`FactorizationSpec` describing the layout. A module stores each
factor as one real tensor of shape ``(2, ...)`` (real and imaginary parts
stacked, the JAX package's storage); the functions here take the factors
as ``(re, im)`` pairs of real tensors, the port's form of a complex
tensor, and contract them with :func:`~..ops.complex_einsum.complex_einsum`.

``resolve_spec`` and ``factor_shapes`` are plain Python and numpy, a copy
of the JAX module's (the port imports nothing of it). Rank semantics follow
tensorly's fraction-of-parameters convention: a float ``rank`` r means
"about r times the dense parameter count".
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.complex_einsum import Parts, complex_einsum

Params = Dict[str, Parts]

_VALID_KINDS = ("dense", "cp", "tucker", "tt")


@dataclass(frozen=True)
class FactorizationSpec:
    """Static description of a factorized weight tensor."""

    kind: str
    shape: Tuple[int, ...]
    ranks: Tuple[int, ...] = ()  # meaning depends on kind

    @property
    def order(self) -> int:
        return len(self.shape)


def _dense_params(shape) -> int:
    return int(np.prod(shape))


def resolve_spec(
    factorization: Optional[str],
    shape: Sequence[int],
    rank=1.0,
    fixed_rank_modes: Optional[Sequence[int]] = None,
) -> FactorizationSpec:
    """Resolve a (possibly fractional) rank into integer factor ranks."""
    shape = tuple(int(s) for s in shape)
    kind = (factorization or "dense").lower()
    if kind not in _VALID_KINDS:
        raise ValueError(
            f"Unknown factorization {factorization!r}; expected one of {_VALID_KINDS}"
        )
    if kind == "dense":
        return FactorizationSpec("dense", shape)

    if kind == "cp":
        if isinstance(rank, float) and rank <= 1.0:
            # tensorly validate_cp_rank: params = rank * sum(shape) (+rank)
            r = max(1, int(round(rank * _dense_params(shape) / sum(shape))))
        else:
            r = int(rank)
        return FactorizationSpec("cp", shape, (r,))

    if kind == "tucker":
        fixed = set(fixed_rank_modes or ())
        if isinstance(rank, (float, int)) and not isinstance(rank, bool) and float(rank) <= 1.0:
            target = float(rank) * _dense_params(shape)

            def params_for(t: float) -> Tuple[int, ...]:
                return tuple(
                    s if i in fixed else max(1, int(round(t * s)))
                    for i, s in enumerate(shape)
                )

            lo, hi = 1e-3, 1.0
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                ranks = params_for(mid)
                n = int(np.prod(ranks)) + sum(r * s for r, s in zip(ranks, shape))
                if n > target:
                    hi = mid
                else:
                    lo = mid
            ranks = params_for(lo)
        elif isinstance(rank, (list, tuple)):
            ranks = tuple(int(r) for r in rank)
        else:
            ranks = tuple(s if i in fixed else int(rank) for i, s in enumerate(shape))
        return FactorizationSpec("tucker", shape, ranks)

    # tt: internal bond ranks r_1..r_{L-1} (r_0 = r_L = 1 implicit)
    L = len(shape)
    if isinstance(rank, float) and rank <= 1.0:
        target = rank * _dense_params(shape)

        def tt_params(r: int) -> int:
            ranks_full = [1] + [r] * (L - 1) + [1]
            return sum(ranks_full[i] * shape[i] * ranks_full[i + 1] for i in range(L))

        r = 1
        while tt_params(r + 1) <= target and r < max(shape) * 4:
            r += 1
        bond = tuple([r] * (L - 1))
    elif isinstance(rank, (list, tuple)):
        bond = tuple(int(x) for x in rank)
    else:
        bond = tuple([int(rank)] * (L - 1))
    return FactorizationSpec("tt", shape, bond)


def factor_shapes(spec: FactorizationSpec) -> Dict[str, Tuple[int, ...]]:
    """Shapes of each factor (complex entries) for a given spec."""
    if spec.kind == "dense":
        return {"weight": spec.shape}
    if spec.kind == "cp":
        (r,) = spec.ranks
        out = {"lambdas": (r,)}
        for i, s in enumerate(spec.shape):
            out[f"factor_{i}"] = (s, r)
        return out
    if spec.kind == "tucker":
        out = {"core": tuple(spec.ranks)}
        for i, (s, r) in enumerate(zip(spec.shape, spec.ranks)):
            out[f"factor_{i}"] = (s, r)
        return out
    ranks_full = (1,) + spec.ranks + (1,)
    return {
        f"factor_{i}": (ranks_full[i], s, ranks_full[i + 1])
        for i, s in enumerate(spec.shape)
    }


def n_params(spec: FactorizationSpec) -> int:
    """Real parameter count (complex entries count twice)."""
    return 2 * sum(int(np.prod(s)) for s in factor_shapes(spec).values())


def init_factors(
    spec: FactorizationSpec,
    std: float,
    device,
    generator: Optional[torch.Generator],
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.nn.Parameter]:
    """Random factors, stored ``(2, ...)``, such that the reconstructed
    tensor has scale about ``std``.

    The reconstructed entry is a sum over ``R`` products of ``T``
    independent factor entries; a per-factor std ``sigma = (std^2 /
    R)^(1/(2T))`` gives it variance ``std^2``. Real and imaginary parts are
    each ``N(0, (sigma / sqrt 2)^2)``, drawn factor by factor from
    ``generator`` in ``factor_shapes`` order (JAX's distribution, not its
    bits). A dense weight is one draw of ``(2, *shape)`` at ``std /
    sqrt 2``.
    """
    from ..layers import _init  # the layers import this module

    shapes = factor_shapes(spec)
    T = len(shapes)
    if spec.kind in ("tucker", "tt"):
        R = int(np.prod(spec.ranks)) if spec.ranks else 1
    elif spec.kind == "cp":
        R = spec.ranks[0]  # one rank index contracted across all factors
    else:
        R = 1
    sigma = (std ** 2 / max(R, 1)) ** (1.0 / (2 * T))
    return {
        name: _init.normal((2, *shape), sigma / 2 ** 0.5, device, generator, dtype)
        for name, shape in shapes.items()
    }


def to_tensor(spec: FactorizationSpec, params: Params) -> Parts:
    """Reconstruct the full (dense) weight tensor from its factors."""
    if spec.kind == "dense":
        return params["weight"]
    syms = _symbols(spec.order)
    factors = [params[f"factor_{i}"] for i in range(spec.order)]
    if spec.kind == "cp":
        eq = "r," + ",".join(f"{s}r" for s in syms) + "->" + syms
        return complex_einsum(eq, params["lambdas"], *factors)
    if spec.kind == "tucker":
        rsyms = _symbols(spec.order, offset=spec.order)
        eq = (rsyms + "," + ",".join(f"{s}{r}" for s, r in zip(syms, rsyms))
              + "->" + syms)
        return complex_einsum(eq, params["core"], *factors)
    # tt: the chain of bond contractions
    rank_syms = _symbols(spec.order + 1, offset=spec.order)
    core_syms = [rank_syms[i] + syms[i] + rank_syms[i + 1] for i in range(spec.order)]
    eq = ",".join(core_syms) + "->" + rank_syms[0] + syms + rank_syms[-1]
    re, im = complex_einsum(eq, *factors)
    return re.squeeze(0).squeeze(-1), im.squeeze(0).squeeze(-1)


def slice_factors(
    spec: FactorizationSpec, params: Params, slices: Sequence[slice]
) -> Tuple[FactorizationSpec, Params]:
    """Slice the weight tensor along its dims, staying in factorized form.

    ``slices`` has one entry per tensor dim: the active modes of an
    incremental-FNO-style truncation sit at the centre of the stored weight.
    """
    slices = tuple(slices)
    if len(slices) != spec.order:
        raise ValueError(f"{len(slices)} slices for a weight of order {spec.order}")
    new_shape = tuple(len(range(*sl.indices(s))) for sl, s in zip(slices, spec.shape))

    def cut(pair: Parts, index) -> Parts:
        return pair[0][index], pair[1][index]

    if spec.kind == "dense":
        return FactorizationSpec("dense", new_shape), {"weight": cut(params["weight"], slices)}
    if spec.kind == "tt":
        out = {f"factor_{i}": cut(params[f"factor_{i}"], (slice(None), sl))
               for i, sl in enumerate(slices)}
        return FactorizationSpec("tt", new_shape, spec.ranks), out
    shared = "lambdas" if spec.kind == "cp" else "core"
    out = {shared: params[shared]}
    out.update({f"factor_{i}": cut(params[f"factor_{i}"], sl) for i, sl in enumerate(slices)})
    return FactorizationSpec(spec.kind, new_shape, spec.ranks), out


def _symbols(n: int, offset: int = 0) -> str:
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return alphabet[offset: offset + n]
