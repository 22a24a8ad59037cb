"""The backward contractions (K2, K3) and ``ModeContraction`` against the JAX Pallas kernel.

The JAX side runs ``_mode_contraction`` with ``_BWD_X``/``_BWD_W`` and
``pallas_mode_contraction``'s custom VJP in interpret mode, on operands in
its (M, ...) layout; the port's plain versions and autograd Function run the
same numpy values in the natural layout. Operands are drawn at the scale of
the model's (x and g unit normal, w at the spectral layer's init std), so
an absolute tolerance means what it says.

Tolerances, stated per comparison:
* f32: ``rtol=1e-5`` and ``atol=1e-6`` times the rms of the expected
  result, the same products summed in another order (the Pallas kernel's
  Karatsuba form adds the cancellation of t3 - t1 - t2, whose rounding
  scales with the result). dx and the forward are O(1) at these scales; dw
  sums B products of unit normals and is O(sqrt(B));
* bf16 operands against the Pallas kernel fed the same bf16-rounded values
  in f32: relative l2 <= 1e-3;
* bf16 operands against the Pallas kernel run in bf16: relative l2 <= 2**-8
  (bf16's unit roundoff). That kernel also rounds its Karatsuba sums
  ar + ai and br + bi to bf16; the port widens each operand exactly.
* ``ModeContraction`` gradients, f32: the f32 tolerance above, against
  ``jax.vjp`` through ``pallas_mode_contraction``; bf16: relative l2 <=
  2**-7, the 2**-8 of the kernel plus the final rounding of dx and dw to
  bf16 on each side (2**-9 each).
"""

import functools

import jax
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


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _operands(seed, B, I, O, M):
    """x (B, I, M), w (I, O, M) and g (B, O, M) parts, natural layout."""
    w_std = (2 / (I + O)) ** 0.5 / 2 ** 0.5
    return (
        (_rand(seed, B, I, M), _rand(seed + 1, B, I, M)),
        (_rand(seed + 2, I, O, M, scale=w_std), _rand(seed + 3, I, O, M, scale=w_std)),
        (_rand(seed + 4, B, O, M), _rand(seed + 5, B, O, M)),
    )


def _close_f32(actual, expected):
    expected = np.asarray(expected)
    rms = float(np.sqrt(np.mean(np.square(expected, dtype=np.float64))))
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=RTOL, atol=ATOL * rms)


def _rel_l2(ar, ai, br, bi):
    ar, ai, br, bi = (np.asarray(t, np.float64) for t in (ar, ai, br, bi))
    return np.sqrt(((ar - br) ** 2 + (ai - bi) ** 2).sum() / (br ** 2 + bi ** 2).sum())


def _to_m(a, dtype):
    return jnp.asarray(np.moveaxis(a, -1, 0), dtype)


def _from_m(a):
    return np.moveaxis(np.asarray(a, np.float32), 0, -1)


def _jax_dx(g, w, dtype):
    """Pallas ``_BWD_X`` with ``conj_b`` on (M, B, O) / (M, I, O), in (B, I, M)."""
    r, i = jsc._mode_contraction(*(_to_m(a, dtype) for a in (*g, *w)),
                                 dn=jsc._BWD_X, conj_b=True)
    return _from_m(r), _from_m(i)


def _jax_dw(x, g, dtype):
    """Pallas ``_BWD_W`` with ``conj_a`` on (M, B, I) / (M, B, O), in (I, O, M)."""
    r, i = jsc._mode_contraction(*(_to_m(a, dtype) for a in (*x, *g)),
                                 dn=jsc._BWD_W, conj_a=True)
    return _from_m(r), _from_m(i)


def _torch(parts, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in parts)


@pytest.mark.parametrize(
    "B,I,O,M",
    [(3, 8, 8, 37), (1, 16, 8, 301), (8, 12, 20, 130),
     # past the 16 batch rows a CUDA block holds, I != O, M not a multiple of 4
     (17, 12, 20, 37), (17, 20, 6, 77)],
)
def test_backward_plain_versions_match_pallas_f32(interpret_pallas, B, I, O, M):
    x, w, g = _operands(0, B, I, O, M)
    for got, want in (
        (tsc.mode_contraction_dx_reference(*_torch(g), *_torch(w)), _jax_dx(g, w, jnp.float32)),
        (tsc.mode_contraction_dw_reference(*_torch(x), *_torch(g)), _jax_dw(x, g, jnp.float32)),
    ):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            _close_f32(a.numpy(), b)


@pytest.mark.parametrize(
    "B,I,O,M",
    [(3, 8, 8, 37), (8, 16, 16, 301),
     # past the 16 batch rows a CUDA block holds, I != O, M not a multiple of 4
     (17, 12, 20, 37), (17, 20, 6, 77)],
)
def test_backward_plain_versions_match_pallas_bf16(interpret_pallas, B, I, O, M):
    x, w, g = _operands(1, B, I, O, M)
    # round once to bf16 so both sides see the same operands
    xb, wb, gb = (_torch(p, torch.bfloat16) for p in (x, w, g))
    x, w, g = ([t.float().numpy() for t in p] for p in (xb, wb, gb))
    for got, jax_fn, args in (
        (tsc.mode_contraction_dx_reference(*gb, *wb), _jax_dx, (g, w)),
        (tsc.mode_contraction_dw_reference(*xb, *gb), _jax_dw, (x, g)),
    ):
        assert got[0].dtype == torch.float32
        assert _rel_l2(*got, *jax_fn(*args, jnp.float32)) <= 1e-3
        assert _rel_l2(*got, *jax_fn(*args, jnp.bfloat16)) <= 2.0 ** -8


def _port_vjp(x, w, g, dtype, need=(True, True, True, True)):
    """Gradients of ``ModeContraction`` for cotangent g (None where not asked)."""
    leaves = [t.requires_grad_(n) for t, n in zip((*_torch(x, dtype), *_torch(w, dtype)), need)]
    out = tsc.ModeContraction.apply(*leaves)
    torch.autograd.backward(out, _torch(g))
    return out, [t.grad for t in leaves]


def _jax_vjp(x, w, g, dtype):
    """``jax.vjp`` through ``pallas_mode_contraction`` in the natural layout."""
    primals = [_to_m(a, dtype) for a in (*x, *w)]
    out, vjp = jax.vjp(jsc.pallas_mode_contraction, *primals)
    grads = vjp(tuple(_to_m(a, jnp.float32) for a in g))
    return [_from_m(o) for o in out], [_from_m(d) for d in grads], grads


@pytest.mark.parametrize("B,I,O,M", [(3, 8, 5, 37), (2, 7, 12, 130), (9, 16, 8, 11)])
def test_mode_contraction_gradients_match_jax_f32(interpret_pallas, B, I, O, M):
    x, w, g = _operands(2, B, I, O, M)
    out, grads = _port_vjp(x, w, g, torch.float32)
    j_out, j_grads, _ = _jax_vjp(x, w, g, jnp.float32)
    for a, b in zip(out, j_out):
        _close_f32(a.detach().numpy(), b)
    for a, b in zip(grads, j_grads):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close_f32(a.numpy(), b)


def test_mode_contraction_gradients_match_jax_bf16(interpret_pallas):
    """The dtype casts of ``_pallas_bwd``: g to w's dtype for dx, to x's for
    dw, each result back to its operand's dtype."""
    x, w, g = _operands(3, 4, 8, 12, 67)
    xb, wb = _torch(x, torch.bfloat16), _torch(w, torch.bfloat16)
    x, w = [t.float().numpy() for t in xb], [t.float().numpy() for t in wb]
    _, grads = _port_vjp(x, w, g, torch.bfloat16)
    _, _, j_raw = _jax_vjp(x, w, g, jnp.bfloat16)
    assert [a.dtype for a in grads] == [torch.bfloat16] * 4
    assert [str(d.dtype) for d in j_raw] == ["bfloat16"] * 4
    j_grads = [_from_m(d) for d in j_raw]
    assert _rel_l2(grads[0].float(), grads[1].float(), *j_grads[:2]) <= 2.0 ** -7
    assert _rel_l2(grads[2].float(), grads[3].float(), *j_grads[2:]) <= 2.0 ** -7


@pytest.mark.parametrize(
    "need", [(True, True, False, False), (False, False, True, True), (False, True, True, False)]
)
def test_mode_contraction_computes_only_the_gradients_asked_for(need, monkeypatch):
    calls = []
    for name in ("mode_contraction_dx", "mode_contraction_dw"):
        fn = getattr(tsc, name)
        monkeypatch.setattr(tsc, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    x, w, g = _operands(4, 2, 4, 5, 9)
    _, grads = _port_vjp(x, w, g, torch.float32, need)
    assert [d is not None for d in grads] == list(need)
    assert sorted(calls) == sorted(
        (["mode_contraction_dx"] if need[0] or need[1] else [])
        + (["mode_contraction_dw"] if need[2] or need[3] else [])
    )


@pytest.mark.parametrize("modes", [(8, 5), (7, 4)])
def test_contract_dense_is_differentiable_like_the_pallas_adapter(interpret_pallas, modes):
    """``contract_dense`` runs through ``ModeContraction`` on the CPU too, and
    its gradients (reshapes included) match ``jax.vjp`` of the JAX adapter."""
    b, i, o = 2, 6, 5
    x = [_rand(10 + k, b, i, *modes) for k in range(2)]
    w = [_rand(12 + k, i, o, *modes, scale=0.3) for k in range(2)]
    g = [_rand(14 + k, b, o, *modes) for k in range(2)]
    tx, tw = [torch.from_numpy(a).requires_grad_() for a in x], [
        torch.from_numpy(a).requires_grad_() for a in w]
    out = tcon.contract_dense(tuple(tx), tuple(tw))
    # the output is the Function's, reshaped back to the mode grid
    (node, _), = out[0].grad_fn.next_functions
    assert type(node).__name__ == "ModeContractionBackward"
    torch.autograd.backward(out, [torch.from_numpy(a) for a in g])
    _, vjp = jax.vjp(lambda xr, xi, wr, wi: jsc.contract_dense_pallas((xr, xi), (wr, wi)),
                     *map(jnp.asarray, (*x, *w)))
    j_grads = vjp(tuple(map(jnp.asarray, g)))
    for t, want in zip((*tx, *tw), j_grads):
        assert tuple(t.grad.shape) == want.shape
        _close_f32(t.grad.numpy(), want)


def test_backward_wrappers_run_plain_versions_on_cpu_and_count_nothing():
    x, w, g = _operands(5, 2, 4, 5, 11)
    before = (tsc.mode_contraction_dx.launches, tsc.mode_contraction_dw.launches)
    for fn, ref, args in (
        (tsc.mode_contraction_dx, tsc.mode_contraction_dx_reference, (*_torch(g), *_torch(w))),
        (tsc.mode_contraction_dw, tsc.mode_contraction_dw_reference, (*_torch(x), *_torch(g))),
    ):
        for a, b in zip(fn(*args), ref(*args)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tsc.mode_contraction_dx.launches, tsc.mode_contraction_dw.launches) == before


@pytest.mark.parametrize(
    "fn,bad,error",
    [
        ("dx", lambda g, w: (g[0], g[1][:1], *w), ValueError),        # parts differ
        ("dx", lambda g, w: (g[0][0], g[1][0], *w), ValueError),       # not 3-d
        ("dx", lambda g, w: (*g, w[0][:, :2], w[1][:, :2]), ValueError),  # O disagrees
        ("dw", lambda x, g: (*x, g[0][:1], g[1][:1]), ValueError),    # B disagrees
        ("dw", lambda x, g: (*x, g[0].double(), g[1].double()), TypeError),
        ("dw", lambda x, g: (*(t.to("meta") for t in x), *(t.to("meta") for t in g)), ValueError),
    ],
)
def test_backward_wrappers_reject_what_the_kernels_do_not_take(fn, bad, error):
    x, w, g = _operands(6, 2, 4, 5, 11)
    if fn == "dx":
        args = bad(_torch(g), _torch(w))
        with pytest.raises(error):
            tsc.mode_contraction_dx(*args)
    else:
        args = bad(_torch(x), _torch(g))
        with pytest.raises(error):
            tsc.mode_contraction_dw(*args)
