"""The port's factorized weights and complex einsum against the JAX package.

``tensor/factorized.py``, ``ops/complex_einsum.py`` and the factorized
contractions of ``ops/contractions.py``, each fed the same numpy factors
and inputs as the JAX functions, at small shapes.

Tolerances:
* ``resolve_spec``, ``factor_shapes``, ``n_params``: equal;
* ``to_tensor``, ``slice_factors``, ``complex_einsum`` and the
  contractions in float32: relative l2 <= 2e-6 (f32 sums in another order;
  a CPU probe read up to 4e-7);
* ``complex_einsum`` and the contractions with bfloat16 products, against
  eager JAX (``jax.disable_jit``): relative l2 <= 2e-2. Both round the same
  operands and the same two sums to bf16 and sum products in f32; where the
  plans agree the results are equal to the bit here (every Tucker case,
  the single pairwise step). The port's plan is searched without numpy's
  memory limit, so where JAX's plan takes another order (a multi-operand
  step contracted left to right) other intermediates are rounded to bf16:
  a CPU probe read 4.6e-3 to 8.2e-3 in those cases (TT, CP), a chain of up
  to five bf16 roundings at other points, each up to 2^-8;
* ``init_factors``: the factors' pooled sample std within 5% of the JAX
  init's, and the rebuilt weight's std within 30% of the target.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.ops import complex_einsum as jce
from neuraloperator_tpu.ops import contractions as jcon
from neuraloperator_tpu.tensor import factorized as jfac
from neuraloperator_tpu_torch.ops import complex_einsum as tce
from neuraloperator_tpu_torch.ops import contractions as tcon
from neuraloperator_tpu_torch.tensor import factorized as tfac

torch.set_num_threads(1)

F32_TOL = 2e-6
BF16_TOL = 2e-2

# (factorization, shape, rank, fixed_rank_modes)
SPECS = [
    ("dense", (4, 5, 6, 4), 1.0, None),
    (None, (4, 5, 6), 0.5, None),
    ("cp", (4, 5, 6, 4), 0.1, None),
    ("cp", (4, 5, 6, 4), 0.5, None),
    ("cp", (8, 8, 8, 5), 1.0, None),
    ("cp", (4, 5, 6, 4), 7, None),
    ("cp", (4, 5, 6, 4), 3.0, None),
    ("tucker", (4, 5, 6, 4), 0.1, None),
    ("tucker", (64, 64, 64, 33), 0.1, None),
    ("tucker", (8, 8, 8, 5), 0.5, [0]),
    ("tucker", (8, 8, 8, 5), 0.3, [0, 3]),
    ("tucker", (8, 8, 8, 5), 1, None),
    ("tucker", (8, 8, 8, 5), 3, [1]),
    ("tucker", (8, 8, 8, 5), (2, 3, 4, 2), None),
    ("tucker", (6, 7, 5), 0.2, None),
    ("TT", (4, 5, 6, 4), 0.1, None),
    ("tt", (8, 8, 8, 5), 0.5, None),
    ("tt", (8, 8, 8, 5), 3, None),
    ("tt", (8, 8, 8, 5), (2, 3, 4), None),
    ("tt", (6, 7, 5), 1.0, None),
]


def _id(case):
    kind, shape, rank, fixed = case
    return f"{kind}-{'x'.join(map(str, shape))}-{rank}-{fixed}"


@pytest.mark.parametrize("case", SPECS, ids=[_id(c) for c in SPECS])
def test_resolve_spec_shapes_and_counts_match_jax(case):
    kind, shape, rank, fixed = case
    expected = jfac.resolve_spec(kind, shape, rank, fixed)
    actual = tfac.resolve_spec(kind, shape, rank, fixed)
    assert (actual.kind, actual.shape, actual.ranks) == \
        (expected.kind, expected.shape, expected.ranks)
    assert tfac.factor_shapes(actual) == jfac.factor_shapes(expected)
    assert tfac.n_params(actual) == jfac.n_params(expected)


def test_resolve_spec_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="Unknown factorization"):
        tfac.resolve_spec("svd", (4, 4), 0.5)


def _factors(spec, seed):
    """Random complex factors: (JAX dict of complex arrays, port dict of parts)."""
    rng = np.random.default_rng(seed)
    jparams, tparams = {}, {}
    for name, shape in tfac.factor_shapes(spec).items():
        re, im = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jparams[name] = jnp.asarray(re + 1j * im, dtype=jnp.complex64)
        tparams[name] = (torch.from_numpy(re), torch.from_numpy(im))
    return jparams, tparams


def _rel(actual, expected) -> float:
    """Relative l2 of port parts against a JAX complex array or parts."""
    if isinstance(expected, tuple):
        er, ei = (np.asarray(jnp.asarray(e, jnp.float32), np.float64) for e in expected)
    else:
        er, ei = np.real(np.asarray(expected)), np.imag(np.asarray(expected))
    ar, ai = (a.detach().double().numpy() for a in actual)
    assert ar.shape == er.shape
    return math.sqrt((np.sum((ar - er) ** 2) + np.sum((ai - ei) ** 2))
                     / (np.sum(er ** 2) + np.sum(ei ** 2)))


FACTORED = [c for c in SPECS if (c[0] or "dense").lower() != "dense" and max(c[1]) < 64]


@pytest.mark.parametrize("case", FACTORED, ids=[_id(c) for c in FACTORED])
def test_to_tensor_and_slice_factors_match_jax(case):
    kind, shape, rank, fixed = case
    spec = tfac.resolve_spec(kind, shape, rank, fixed)
    jspec = jfac.resolve_spec(kind, shape, rank, fixed)
    jparams, tparams = _factors(spec, 0)
    assert _rel(tfac.to_tensor(spec, tparams), jfac.to_tensor(jspec, jparams)) <= F32_TOL
    # a centred cut of every mode dim and the start of the last, as the layer slices
    slices = [slice(None)] + [slice(1, -1)] * (spec.order - 2) + [slice(None, -1)]
    sspec, sparams = tfac.slice_factors(spec, tparams, slices)
    jsspec, jsparams = jfac.slice_factors(jspec, jparams, slices)
    assert sspec == tfac.FactorizationSpec(jsspec.kind, jsspec.shape, jsspec.ranks)
    assert _rel(tfac.to_tensor(sspec, sparams), jfac.to_tensor(jsspec, jsparams)) <= F32_TOL


def test_slice_factors_checks_the_order():
    spec = tfac.resolve_spec("tucker", (4, 5, 6), 0.5)
    _, params = _factors(spec, 0)
    with pytest.raises(ValueError, match="slices"):
        tfac.slice_factors(spec, params, [slice(None)] * 2)


@pytest.mark.parametrize("kind", ["dense", "cp", "tucker", "tt"])
def test_init_factors_follow_the_jax_distributions(kind):
    spec = tfac.resolve_spec(kind, (16, 16, 12, 7), 0.5)
    std = 0.25
    jparams = jfac.init_factors(jax.random.PRNGKey(0), spec, std)
    tparams = tfac.init_factors(spec, std, "cpu", torch.Generator().manual_seed(0))
    assert list(tparams) == list(jparams)
    for name, p in tparams.items():
        assert p.shape == (2, *jparams[name].shape)
    # every factor has one std: pooled over the factors, as both draw it
    j_std = np.std(np.concatenate([np.concatenate([np.real(a).ravel(), np.imag(a).ravel()])
                                   for a in jparams.values()]))
    t_std = float(torch.cat([p.detach().ravel() for p in tparams.values()]).std())
    assert abs(t_std / j_std - 1) < 0.05
    with torch.no_grad():
        rebuilt = tfac.to_tensor(spec, {n: (p[0].detach(), p[1].detach())
                                        for n, p in tparams.items()})
    scale = float(torch.cat([rebuilt[0].ravel(), rebuilt[1].ravel()]).std())
    assert 0.7 * std / 2 ** 0.5 < scale < 1.3 * std / 2 ** 0.5


# ------------------------------------------------------- complex einsum --

EINSUMS = [
    ("ab,bc->ac", [(5, 6), (6, 7)]),
    ("abc,cd,db->a", [(3, 4, 5), (5, 6), (6, 4)]),
    ("abcd,fghi,bf,eg,ch,di->aecd", [(2, 4, 5, 3), (3, 2, 3, 2), (4, 3), (6, 2), (5, 3), (3, 2)]),
    ("r,ar,br,cr->abc", [(7,), (4, 7), (5, 7), (3, 7)]),
    ("eaf,fbg,gch->eabch", [(1, 4, 3), (3, 5, 2), (2, 6, 1)]),
    ("abc->cb", [(3, 4, 5)]),
]


def _operands(shapes, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        re, im = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
        out.append(((jnp.asarray(re), jnp.asarray(im)),
                    (torch.from_numpy(re), torch.from_numpy(im))))
    return [j for j, _ in out], [t for _, t in out]


@pytest.mark.parametrize("eq,shapes", EINSUMS, ids=[e for e, _ in EINSUMS])
def test_complex_einsum_f32_matches_jax(eq, shapes):
    jops, tops = _operands(shapes, 1)
    expected = jce.complex_einsum(eq, *jops, return_parts=True)
    actual = tce.complex_einsum(eq, *tops)
    assert actual[0].dtype == torch.float32
    assert _rel(actual, expected) <= F32_TOL


@pytest.mark.parametrize("eq,shapes", EINSUMS[:5], ids=[e for e, _ in EINSUMS[:5]])
def test_complex_einsum_bf16_products_match_eager_jax(eq, shapes):
    jops, tops = _operands(shapes, 2)
    with jax.disable_jit():
        expected = jce.complex_einsum(eq, *jops, return_parts=True,
                                      compute_dtype=jnp.bfloat16)
    actual = tce.complex_einsum(eq, *tops, compute_dtype=torch.bfloat16)
    assert actual[0].dtype == torch.float32
    assert _rel(actual, expected) <= BF16_TOL
    # bf16 products are not f32 products
    assert _rel(actual, jce.complex_einsum(eq, *jops, return_parts=True)) > 1e-4


def test_pairwise_bf16_rounds_operands_and_sums_as_jax():
    """One pairwise step: the rounding points are JAX's to the bit (one
    product of exact bf16 values summed in f32 over a short axis)."""
    jops, tops = _operands([(4, 3), (3, 5)], 3)
    with jax.disable_jit():
        expected = jce._pairwise_complex("ab,bc->ac", *jops, compute_dtype=jnp.bfloat16)
    actual = tce._pairwise_complex("ab,bc->ac", *tops, compute_dtype=torch.bfloat16)
    for a, e in zip(actual, expected):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6, atol=1e-6)


def test_complex_einsum_takes_complex_and_real_operands():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    b = rng.standard_normal((4, 2)).astype(np.float32)
    expected = jce.complex_einsum("ab,bc->ac", jnp.asarray(a, jnp.complex64), jnp.asarray(b))
    actual = tce.complex_einsum("ab,bc->ac", torch.from_numpy(a.astype(np.complex64)),
                                torch.from_numpy(b))
    assert _rel(actual, expected) <= F32_TOL
    with pytest.raises(ValueError, match="operands"):
        tce.complex_einsum("ab,bc->ac", torch.from_numpy(b))


def test_plans_are_cached_and_symbolic_dims_plan_as_eight():
    eq = "abcd,fghi,bf,eg,ch,di->aecd"
    shapes = ((8, 4, 5, 3), (3, 2, 3, 2), (4, 3), (6, 2), (5, 3), (3, 2))
    assert tce.plan(eq, shapes) is tce.plan(eq, shapes)
    assert tce._plan_dim(5) == 5
    assert tce._plan_dim(np.int64(7)) == 7
    assert tce._plan_dim(object()) == 8


# ------------------------------------------------------------ the planner --

# the flagship TFNO's spectral layer: x (B, 64, 64, 33), Tucker rank 0.1
TUCKER_EQ = "abcd,fghi,bf,eg,ch,di->aecd"
CORE, FACTORS = (36, 36, 36, 18), ((64, 36), (64, 36), (64, 36), (33, 18))


def _cost(eq, shapes, program):
    """(pairwise steps only?, complex MACs, largest intermediate) of a program."""
    dims = {}
    for sub, shape in zip(eq.split("->")[0].split(","), shapes):
        dims.update(zip(sub, shape))
    macs, largest, pairwise = 0, 0, True
    for idxs, eqs in program:
        pairwise &= len(idxs) <= 2
        for pair_eq in eqs:
            ins, out = pair_eq.split("->")
            macs += math.prod(dims[c] for c in set(ins.replace(",", "")))
            largest = max(largest, math.prod(dims[c] for c in out))
    return pairwise, macs, largest


def _jax_program(eq, shapes):
    """The JAX function's program: numpy's path under its default memory
    limit, each step contracted pairwise in list order."""
    inputs, output = eq.split("->")
    work = inputs.split(",")
    path, _ = np.einsum_path(eq, *[np.broadcast_to(np.float32(0), s) for s in shapes],
                             optimize="optimal")
    program = []
    for step in path[1:]:
        idxs = sorted(step, reverse=True)
        subs = [work[i] for i in idxs][::-1]
        for i in idxs:
            work.pop(i)
        cur, eqs = subs[0], []
        for k, nxt in enumerate(subs[1:]):
            out = tce._pair_output_subscript(cur, nxt, work + subs[k + 2:], output)
            eqs.append(f"{cur},{nxt}->{out}")
            cur = out
        program.append((tuple(idxs), tuple(eqs)))
        work.append(cur)
    return program


@pytest.mark.parametrize("batch", [1, 8, 10, 12, 16, 20, 24, 32])
def test_tucker_plan_at_flagship_shapes_is_pairwise_and_small(batch):
    shapes = ((batch, 64, 64, 33), CORE, *FACTORS)
    pairwise, macs, largest = _cost(TUCKER_EQ, shapes, tce.plan(TUCKER_EQ, shapes))
    assert pairwise
    assert largest < 2e7
    assert macs < 1e9
    if batch in (12, 16, 20):
        # the JAX plan at these batches: a multi-operand step whose list
        # order builds a >= 1e9-element intermediate (ROADMAP §C)
        _, jax_macs, jax_largest = _cost(TUCKER_EQ, shapes, _jax_program(TUCKER_EQ, shapes))
        assert jax_largest >= 1e9 and jax_macs > 30 * macs


# -------------------------------------------------------- contractions --

CONTRACT_CASES = [
    (kind, separable, order)
    for kind in ("dense", "cp", "tucker", "tt")
    for separable in (False, True)
    for order in (1, 2, 3)
]


def _contract_inputs(kind, separable, order, seed):
    modes = {1: (6,), 2: (5, 4), 3: (4, 3, 3)}[order]
    channels = (5,) if separable else (5, 4)
    spec = tfac.resolve_spec(kind, (*channels, *modes), 0.5)
    jspec = jfac.resolve_spec(kind, (*channels, *modes), 0.5)
    jparams, tparams = _factors(spec, seed)
    (jx,), (tx,) = _operands([(3, 5, *modes)], seed + 1)
    return spec, jspec, jparams, tparams, jx, tx


@pytest.mark.parametrize("implementation", ["factorized", "reconstructed"])
@pytest.mark.parametrize("kind,separable,order", CONTRACT_CASES,
                         ids=[f"{k}-{'sep' if s else 'full'}-{o}d" for k, s, o in CONTRACT_CASES])
def test_contract_block_matches_jax(kind, separable, order, implementation):
    spec, jspec, jparams, tparams, jx, tx = _contract_inputs(kind, separable, order, 5)
    expected = jcon.contract_block(jx, jspec, jparams, separable=separable,
                                   implementation=implementation, return_parts=True)
    actual = tcon.contract_block(tx, spec, tparams, separable=separable,
                                 implementation=implementation)
    assert _rel(actual, expected) <= F32_TOL


# XLA's CPU dot has no bf16 x bf16 -> f32 form for CP's products with the
# rank vector in 1-D and 2-D (the JAX function raises there, eager or jitted)
BF16_CASES = [("tucker", 1), ("tucker", 2), ("tucker", 3), ("tt", 1), ("tt", 2), ("tt", 3),
              ("cp", 3)]


@pytest.mark.parametrize("kind,order", BF16_CASES, ids=[f"{k}-{o}d" for k, o in BF16_CASES])
def test_factorized_contractions_with_bf16_products_match_eager_jax(kind, order):
    spec, jspec, jparams, tparams, jx, tx = _contract_inputs(kind, False, order, 6)
    fn = {"cp": jcon.contract_cp, "tucker": jcon.contract_tucker, "tt": jcon.contract_tt}[kind]
    with jax.disable_jit():
        expected = fn(jx, jparams, jspec, return_parts=True, compute_dtype=jnp.bfloat16)
    actual = tcon.contract_block(tx, spec, tparams, implementation="factorized",
                                 compute_dtype=torch.bfloat16)
    assert _rel(actual, expected) <= BF16_TOL


def test_factorized_and_reconstructed_agree_and_gradients_reach_every_factor():
    spec, _, _, tparams, _, tx = _contract_inputs("tucker", False, 2, 7)
    leaves = {n: (r.clone().requires_grad_(), i.clone().requires_grad_())
              for n, (r, i) in tparams.items()}
    grads = {}
    for impl in ("factorized", "reconstructed"):
        out = tcon.contract_block(tx, spec, leaves, implementation=impl)
        loss = (out[0] ** 2).sum() + (out[1] * out[0]).sum()
        grads[impl] = torch.autograd.grad(loss, [t for p in leaves.values() for t in p])
    for gf, gr in zip(grads["factorized"], grads["reconstructed"]):
        assert gf.abs().sum() > 0
        assert float((gf - gr).norm() / gr.norm()) <= 1e-5


def test_contract_block_rejects_an_unknown_implementation():
    spec, _, _, tparams, _, tx = _contract_inputs("cp", False, 1, 8)
    with pytest.raises(ValueError, match="implementation"):
        tcon.contract_block(tx, spec, tparams, implementation="fused")
