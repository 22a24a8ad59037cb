"""Reduced-precision complex einsums (port of
``neuraloperator_tpu/layers/einsum_utils.py``): the operands' real and
imaginary parts rounded through bfloat16 around the split-real
``ops.complex_einsum`` (float32 products and sums). Results are ``(re,
im)`` pairs, the port's form of a complex tensor."""

import torch

from ..ops.complex_einsum import Parts, complex_einsum, split_complex


def einsum_complexhalf(eq: str, *ops) -> Parts:
    """``complex_einsum`` on operands rounded through bfloat16."""

    def to_half(x):
        r, i = split_complex(x)
        return r.to(torch.bfloat16).float(), i.to(torch.bfloat16).float()

    return complex_einsum(eq, *[to_half(op) for op in ops])


def einsum_complexhalf_two_input(eq: str, a, b) -> Parts:
    """The two-operand form: ``einsum_complexhalf(eq, a, b)``."""
    return einsum_complexhalf(eq, a, b)
