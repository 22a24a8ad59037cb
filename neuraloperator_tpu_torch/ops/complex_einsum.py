"""Complex einsum as a chain of real einsums (port of
``neuraloperator_tpu/ops/complex_einsum.py``).

Operands and results are ``(re, im)`` pairs of real tensors, the port's
form of a complex tensor. The einsum is planned as a chain of pairwise
contractions (``np.einsum_path``), and each pairwise step runs as three
real einsums (Karatsuba):

    rr = Ar Br;  ii = Ai Bi;  s = (Ar + Ai)(Br + Bi)
    Cr = rr - ii;  Ci = s - rr - ii

One documented departure from the JAX function: the plan is searched with
no memory limit. Under numpy's default limit (the largest operand) the
"optimal" search returns one step of three to five operands, which JAX
then contracts pairwise in list order; at the flagship's Tucker shapes
that builds a 1.4G-element intermediate at batch 16. Without the limit
every step is pairwise and the batch costs what numpy's optimal path
costs (ROADMAP §C). Plans are cached per equation and shapes: the search
costs host time that an eager call would pay each time.

The einsums carry no precision of their own: f32 products follow the
process's matmul precision (``training.setup``), as the JAX einsums follow
JAX's default.
"""

import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Parts = Tuple[torch.Tensor, torch.Tensor]
Operand = Union[Parts, torch.Tensor]

# a memory limit no plan reaches: every step of the "optimal" path is pairwise
_NO_MEMORY_LIMIT = 2 ** 62
# the stand-in size of a symbolic dim (torch.export), as the JAX function plans one
_SYMBOLIC_DIM = 8


def split_complex(x: Operand) -> Parts:
    """``(re, im)`` of an operand: a pair as it is, a complex tensor split,
    a real tensor with a zero imaginary part."""
    if isinstance(x, tuple):
        return x
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def _pair_output_subscript(
    sub_a: str, sub_b: str, remaining: Sequence[str], final_out: str
) -> str:
    """Indices surviving a pairwise contraction: those still needed later."""
    needed = set(final_out)
    for s in remaining:
        needed |= set(s)
    return "".join(ch for ch in dict.fromkeys(sub_a + sub_b) if ch in needed)


def _pairwise_complex(eq: str, a: Parts, b: Parts,
                      compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """(ar, ai), (br, bi) -> float32 (cr, ci) through three real einsums.

    With ``compute_dtype`` (bfloat16) the four operands and the two sums
    ``ar + ai``, ``br + bi`` are rounded to it, as the JAX function rounds
    them, and contracted in float32: a product of two bf16 values is exact
    in f32 (and in TF32), so this is JAX's bf16 einsum with f32 sums
    (``preferred_element_type``), which ``torch.einsum`` on bf16 operands
    is not (it returns bf16).
    """
    ar, ai = a
    br, bi = b
    if compute_dtype is not None:
        ar, ai, br, bi = (t.to(compute_dtype) for t in (ar, ai, br, bi))
        sa, sb = (ar + ai).float(), (br + bi).float()
        ar, ai, br, bi = (t.float() for t in (ar, ai, br, bi))
    else:
        sa, sb = ar + ai, br + bi
    rr = torch.einsum(eq, ar, br)
    ii = torch.einsum(eq, ai, bi)
    s = torch.einsum(eq, sa, sb)
    return rr - ii, s - rr - ii


def _single_complex(eq: str, a: Parts) -> Parts:
    return torch.einsum(eq, a[0]), torch.einsum(eq, a[1])


def _plan_dim(d) -> int:
    return int(d) if isinstance(d, (int, np.integer)) else _SYMBOLIC_DIM


@functools.lru_cache(maxsize=256)
def plan(eq: str, shapes: Tuple[Tuple[int, ...], ...]) -> Tuple[tuple, ...]:
    """The contraction program of ``eq`` at ``shapes``: one entry per step
    of ``np.einsum_path``, ``(operand positions, equations)``, where the
    positions (descending) leave the working list and the equations, each
    pairwise or single-operand, run left to right to make the one operand
    appended in their place. Cached."""
    inputs, output = eq.replace(" ", "").split("->")
    work = inputs.split(",")
    dummies = [np.broadcast_to(np.float32(0), s) for s in shapes]
    path, _ = np.einsum_path(eq, *dummies, optimize=("optimal", _NO_MEMORY_LIMIT))
    program = []
    for step in path[1:]:  # the first entry is the string 'einsum_path'
        idxs = tuple(sorted(step, reverse=True))
        if len(idxs) == 1:
            sub = work.pop(idxs[0])
            out_sub = _pair_output_subscript(sub, "", work, output)
            program.append((idxs, (f"{sub}->{out_sub}",)))
            work.append(out_sub)
            continue
        # contract pairs left to right within the step
        step_subs = [work[i] for i in idxs][::-1]
        for i in idxs:
            work.pop(i)
        cur, eqs = step_subs[0], []
        for k, nxt in enumerate(step_subs[1:]):
            pending = step_subs[k + 2:]  # step operands not yet contracted
            out_sub = _pair_output_subscript(cur, nxt, list(work) + pending, output)
            eqs.append(f"{cur},{nxt}->{out_sub}")
            cur = out_sub
        program.append((idxs, tuple(eqs)))
        work.append(cur)
    if work[0] != output:
        program.append(((0,), (f"{work[0]}->{output}",)))
    return tuple(program)


def complex_einsum(eq: str, *ops: Operand,
                   compute_dtype: Optional[torch.dtype] = None) -> Parts:
    """Evaluate a complex einsum; returns float32 ``(re, im)`` (the dtype of
    the operands when a single operand is only transposed or summed).

    Operands are ``(re, im)`` pairs, complex tensors or real tensors.
    ``compute_dtype`` selects the precision of the products' operands
    (sums stay float32); intermediates and outputs are float32.
    """
    subs = eq.replace(" ", "").split("->")[0].split(",")
    if len(subs) != len(ops):
        raise ValueError(f"{eq!r} names {len(subs)} operands, got {len(ops)}")
    parts: List[Parts] = [split_complex(op) for op in ops]
    if len(parts) == 1:
        return _single_complex(eq, parts[0])
    shapes = tuple(tuple(_plan_dim(d) for d in p[0].shape) for p in parts)
    for idxs, eqs in plan(eq, shapes):
        step_ops = [parts.pop(i) for i in idxs][::-1]
        cur = step_ops[0]
        if len(step_ops) == 1:
            cur = _single_complex(eqs[0], cur)
        else:
            for pair_eq, nxt in zip(eqs, step_ops[1:]):
                cur = _pairwise_complex(pair_eq, cur, nxt, compute_dtype)
        parts.append(cur)
    return parts[0]
