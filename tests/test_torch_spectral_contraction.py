"""The port's mode contraction against the JAX Pallas kernel (interpret mode).

Operands are drawn at the scale of the model's: x unit normal, w with the
spectral layer's init std ``sqrt(2 / (I + O)) / sqrt(2)`` per part, so the
outputs are O(1) and an absolute tolerance means what it says.

Tolerances, stated per comparison:
* f32: ``rtol=1e-5, atol=1e-6`` against the Pallas kernel in interpret mode
  (the same products summed in another order; the Pallas kernel's
  Karatsuba form adds the cancellation of t3 - t1 - t2);
* bf16 operands: relative l2 <= 1e-3 against the Pallas kernel fed the same
  bf16-rounded operands;
* bf16 operands against the Pallas kernel run in bf16: relative l2 <= 2**-8
  (bf16's unit roundoff). That kernel rounds its Karatsuba sums ar + ai and
  br + bi to bf16 as well, which the port's four-product form, widening each
  operand exactly to f32, does not.

The CUDA kernel itself is held to this plain version on the card by
``tests/test_torch_on_card.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuraloperator_tpu.ops.pallas import spectral_contraction as jsc
from neuraloperator_tpu_torch.ops import contractions as tcon
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _operands(seed, B, I, O, M):
    """x parts (B, I, M) and w parts (I, O, M), natural layout."""
    w_std = np.float32((2 / (I + O)) ** 0.5 / 2 ** 0.5)
    return (_rand(seed, B, I, M), _rand(seed + 1, B, I, M),
            w_std * _rand(seed + 2, I, O, M), w_std * _rand(seed + 3, I, O, M))


def _rel_l2(ar, ai, br, bi):
    ar, ai, br, bi = (np.asarray(t, np.float64) for t in (ar, ai, br, bi))
    return np.sqrt(((ar - br) ** 2 + (ai - bi) ** 2).sum() / (br ** 2 + bi ** 2).sum())


def _jax_kernel(xr, xi, wr, wi, dtype):
    """Pallas forward on (M, B, I) / (M, I, O), returned in (B, O, M)."""
    to_m = lambda a: jnp.asarray(np.moveaxis(a, -1, 0), dtype)  # noqa: E731
    o_r, o_i = jsc.pallas_mode_contraction(to_m(xr), to_m(xi), to_m(wr), to_m(wi))
    return np.moveaxis(np.asarray(o_r), 0, -1), np.moveaxis(np.asarray(o_i), 0, -1)


@pytest.mark.parametrize(
    "B,I,O,M",
    [(3, 8, 8, 37), (1, 16, 8, 301), (8, 12, 20, 130),
     # past the 16 batch rows a CUDA block holds, I != O, M not a multiple of 4
     (17, 12, 20, 37), (17, 20, 6, 77)],
)
def test_plain_matches_pallas_f32(interpret_pallas, B, I, O, M):
    ops = _operands(0, B, I, O, M)
    tr, ti = tsc.mode_contraction_reference(*map(torch.from_numpy, ops))
    jr, ji = _jax_kernel(*ops, jnp.float32)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), ji, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "B,I,O,M",
    [(3, 8, 8, 37), (8, 16, 16, 301),
     # past the 16 batch rows a CUDA block holds, I != O, M not a multiple of 4
     (17, 12, 20, 37), (17, 20, 6, 77)],
)
def test_plain_matches_pallas_bf16(interpret_pallas, B, I, O, M):
    ops = _operands(1, B, I, O, M)
    # round once to bf16 so both sides see the same operands
    ops_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in ops]
    tr, ti = tsc.mode_contraction_reference(*ops_bf16)
    assert tr.dtype == torch.float32
    rounded = [t.float().numpy() for t in ops_bf16]
    jr, ji = _jax_kernel(*rounded, jnp.float32)
    assert _rel_l2(tr, ti, jr, ji) <= 1e-3
    jr, ji = _jax_kernel(*rounded, jnp.bfloat16)
    assert _rel_l2(tr, ti, jr, ji) <= 2.0 ** -8


@pytest.mark.parametrize("modes", [(8, 5), (7, 4)])
def test_contract_dense_matches_pallas_adapter(interpret_pallas, modes):
    b, i, o = 2, 8, 12
    xr, xi = _rand(4, b, i, *modes), _rand(5, b, i, *modes)
    wr, wi = _rand(6, i, o, *modes), _rand(7, i, o, *modes)
    tr, ti = tcon.contract_dense(
        (torch.from_numpy(xr), torch.from_numpy(xi)),
        (torch.from_numpy(wr), torch.from_numpy(wi)),
    )
    jr, ji = jsc.contract_dense_pallas((xr, xi), (wr, wi))
    assert tuple(tr.shape) == (b, o, *modes)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)


def test_contract_dense_takes_strided_weight():
    """A sliced (non-contiguous) weight is made contiguous, not refused."""
    w = torch.from_numpy(_rand(8, 2, 4, 6, 9, 5))[..., 1:-2, :4]
    x = torch.from_numpy(_rand(9, 2, 3, 4, 6, 4))
    tr, ti = tcon.contract_dense((x[0], x[1]), (w[0], w[1]))
    er, ei = tsc.mode_contraction_reference(
        x[0].reshape(3, 4, -1), x[1].reshape(3, 4, -1),
        w[0].reshape(4, 6, -1), w[1].reshape(4, 6, -1),
    )
    torch.testing.assert_close(tr, er.reshape(3, 6, 6, 4), rtol=0, atol=0)
    torch.testing.assert_close(ti, ei.reshape(3, 6, 6, 4), rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing():
    ops = [torch.from_numpy(a) for a in _operands(10, 2, 4, 5, 11)]
    before = tsc.mode_contraction.launches
    out = tsc.mode_contraction(*ops)
    ref = tsc.mode_contraction_reference(*ops)
    assert tsc.mode_contraction.launches == before
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "bad, error",
    [
        (lambda xr, xi, wr, wi: (xr, xi[:1], wr, wi), ValueError),
        (lambda xr, xi, wr, wi: (xr, xi, wr[:, :, :3], wi[:, :, :3]), ValueError),
        (lambda xr, xi, wr, wi: (xr[0], xi[0], wr, wi), ValueError),
        (lambda xr, xi, wr, wi: (xr, xi, wr.double(), wi.double()), TypeError),
        (lambda xr, xi, wr, wi: (xr.to("meta"), xi.to("meta"), wr.to("meta"), wi.to("meta")),
         ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    ops = [torch.from_numpy(a) for a in _operands(11, 2, 4, 5, 11)]
    with pytest.raises(error):
        tsc.mode_contraction(*bad(*ops))



@pytest.mark.parametrize("dx", [False, True])
def test_plan_raises_on_what_the_kernel_does_not_take(dx):
    """``mode_contraction_plan`` launches nothing: it refuses operands off a
    card, and operands that disagree in shape, as the kernel does."""
    ops = [torch.from_numpy(a) for a in _operands(12, 2, 4, 4, 11)]
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="no kernel for device"):
            tsc.mode_contraction_plan(*(t.to(dev) for t in ops), dx=dx)
    with pytest.raises(ValueError, match="disagree"):
        tsc.mode_contraction_plan(*ops[:2], ops[2][:, :, :3], ops[3][:, :, :3], dx=dx)
