"""The port's CUDA kernels and served path on an NVIDIA GPU.

Every test here needs the card (marker ``gpu``) and skips without one.
The file imports nothing of JAX, so it also runs on the GPU machine, which
has none; ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_on_card.py

Tolerances: relative l2 <= 1e-5 (f32 operands) and 1e-3 (bf16 operands)
for each kernel (K1, K2, K3) against its plain version on the same
operands; the served FNO on the card against the same weights on the CPU:
relative l2 <= 1e-5 (f32, TF32 off). Gradients of a small FNO on the card
against the same model's CPU gradients: relative l2 <= 1e-4 per parameter
(f32 throughout, but a gradient sums over the batch and every grid point in
another order on each device, through 2 layers of DFT matmuls). The
Navier–Stokes solver on the card against the CPU: relative l2 <= 1e-5 per
snapshot after one record of 1000 steps (cuFFT and pocketfft round
differently: 1.7e-7 measured at 128², see chip_smoke.py's SOLVER_TOL). The evaluation of the
published weights on the card against the CPU: each figure within 1e-4
relative.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.models import model_from_metadata
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
from neuraloperator_tpu_torch.serving import CompiledForward

torch.set_num_threads(1)

METADATA = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2/model_metadata.json"
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")


def _rel_l2(ar, ai, br, bi):
    ar, ai, br, bi = (t.double() for t in (ar, ai, br, bi))
    return float((((ar - br) ** 2 + (ai - bi) ** 2).sum() / (br ** 2 + bi ** 2).sum()).sqrt())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,I,O,M",
    [
        (1, 64, 64, 2112), (2, 64, 64, 2112), (3, 64, 64, 2112), (8, 64, 64, 2112),
        (16, 64, 64, 2112),  # the evaluation's batch
        (5, 7, 9, 100),     # channel tails, I not a multiple of the load batch
        (13, 66, 20, 77),   # two batch tiles, ragged mode tile
    ],
)
def test_kernel_matches_plain(card, dtype, B, I, O, M):
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + M)
    w_std = (2 / (I + O)) ** 0.5 / 2 ** 0.5
    xr, xi = (torch.randn(B, I, M, generator=g, device="cuda").to(dtype) for _ in range(2))
    wr, wi = ((w_std * torch.randn(I, O, M, generator=g, device="cuda")).to(dtype)
              for _ in range(2))
    before = tsc.mode_contraction.launches
    kr, ki = tsc.mode_contraction(xr, xi, wr, wi)
    torch.cuda.synchronize()
    assert tsc.mode_contraction.launches == before + 1
    assert kr.dtype == torch.float32 and kr.shape == (B, O, M)
    pr, pi = tsc.mode_contraction_reference(xr, xi, wr, wi)
    assert _rel_l2(kr, ki, pr, pi) <= TOL[dtype]


def test_kernel_refuses_strided_operands(card):
    x = torch.randn(2, 8, 40, device="cuda")
    w = torch.randn(8, 4, 40, device="cuda")
    strided = torch.randn(2, 40, 8, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tsc.mode_contraction(strided, x, w, w)


def test_served_fno_matches_the_cpu(card):
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[16, 16], hidden_channels=16, n_layers=2)
    model = model_from_metadata(meta, device="cuda", generator=torch.Generator().manual_seed(0))
    cpu_model = model_from_metadata(meta, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    example = torch.zeros(1, 1, 64, 64)
    served = CompiledForward(model, example, batch_sizes=(1, 4), device="cuda")
    cpu_served = CompiledForward(cpu_model, example, batch_sizes=(1, 4), device="cpu")
    x = torch.randn(3, 1, 64, 64, generator=torch.Generator().manual_seed(1))
    before = tsc.mode_contraction.launches
    y = served(x).cpu()
    assert tsc.mode_contraction.launches == before + 2  # one per spectral layer
    ref = cpu_served(x)
    assert y.shape == ref.shape == (3, 1, 64, 64)
    assert float((y.double() - ref.double()).norm() / ref.double().norm()) <= 1e-5


def _parts(g, dtype, *shape, scale=1.0):
    return tuple((scale * torch.randn(*shape, generator=g, device="cuda")).to(dtype)
                 for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,I,O,M",
    [
        (1, 64, 64, 2112), (8, 64, 64, 2112),
        (5, 7, 9, 100),     # channel tails, O not a multiple of the load batch
        (13, 66, 20, 77),   # two batch tiles, ragged mode tile
        (3, 9, 70, 33),     # I not a multiple of the channel groups
        # K3's edges: the CPU-comparison step's batch; slices too large to
        # stay resident (streamed in batch chunks); more mode tiles than SMs
        (2, 64, 64, 2112), (32, 128, 128, 2112), (8, 64, 64, 4 * 2112),
    ],
)
def test_backward_kernels_match_plain(card, dtype, B, I, O, M):
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + M + 7)
    w_std = (2 / (I + O)) ** 0.5 / 2 ** 0.5
    x = _parts(g, dtype, B, I, M)
    w = _parts(g, dtype, I, O, M, scale=w_std)
    grad = _parts(g, dtype, B, O, M)
    before = (tsc.mode_contraction_dx.launches, tsc.mode_contraction_dw.launches)
    dxr, dxi = tsc.mode_contraction_dx(*grad, *w)
    dwr, dwi = tsc.mode_contraction_dw(*x, *grad)
    torch.cuda.synchronize()
    assert (tsc.mode_contraction_dx.launches, tsc.mode_contraction_dw.launches) == (
        before[0] + 1, before[1] + 1)
    assert dxr.dtype == dwr.dtype == torch.float32
    assert dxr.shape == (B, I, M) and dwr.shape == (I, O, M)
    assert _rel_l2(dxr, dxi, *tsc.mode_contraction_dx_reference(*grad, *w)) <= TOL[dtype]
    assert _rel_l2(dwr, dwi, *tsc.mode_contraction_dw_reference(*x, *grad)) <= TOL[dtype]
    # K3 sums the batch in one thread, in order: a second launch is bit-identical
    again_r, again_i = tsc.mode_contraction_dw(*x, *grad)
    assert torch.equal(again_r, dwr) and torch.equal(again_i, dwi)


@pytest.mark.parametrize(
    "dtype,B,I,O,M,schedule,load",
    [
        (torch.float32, 8, 64, 64, 2112, "resident", "cp.async"),
        (torch.bfloat16, 8, 64, 64, 2112, "resident", "cp.async"),
        (torch.float32, 32, 128, 128, 2112, "streamed", "cp.async"),
        (torch.float32, 13, 66, 20, 77, "streamed", "element"),
        (torch.bfloat16, 13, 66, 20, 77, "resident", "element"),
        (torch.bfloat16, 5, 7, 9, 100, "resident", "element"),  # M * 2 B not a multiple of 16
    ],
)
def test_weight_grad_takes_the_planned_path(card, dtype, B, I, O, M, schedule, load):
    x = tuple(torch.zeros(B, I, M, device="cuda", dtype=dtype) for _ in range(2))
    g = tuple(torch.zeros(B, O, M, device="cuda", dtype=dtype) for _ in range(2))
    plan = tsc.mode_contraction_dw_plan(*x, *g)
    assert (plan["schedule"], plan["load"]) == (schedule, load)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert min(plan["units"], sms) <= plan["grid"] <= plan["units"]  # persistent


def test_backward_kernels_refuse_strided_operands(card):
    g = torch.randn(2, 4, 40, device="cuda")
    w = torch.randn(8, 4, 40, device="cuda")
    x = torch.randn(2, 8, 40, device="cuda")
    strided_g = torch.randn(2, 40, 4, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tsc.mode_contraction_dx(strided_g, g, w, w)
    with pytest.raises(ValueError, match="contiguous"):
        tsc.mode_contraction_dw(x, x, strided_g, g)


def test_fno_gradients_on_the_card_match_the_cpu(card):
    """Every parameter, the spectral weights included, gets a gradient on the
    card, equal to the same model's CPU gradient; the backward launches K2
    and K3 once per spectral layer."""
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[16, 16], hidden_channels=16, n_layers=2)
    model = model_from_metadata(meta, device="cuda", generator=torch.Generator().manual_seed(0))
    cpu_model = model_from_metadata(meta, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(2)
    x, y = torch.randn(4, 1, 64, 64, generator=gen), torch.randn(4, 1, 64, 64, generator=gen)
    launches = [getattr(tsc, n, None) for n in ("mode_contraction_dx", "mode_contraction_dw")]
    before = [getattr(fn, "launches", 0) for fn in launches]
    (model(x.cuda()) - y.cuda()).square().mean().backward()
    torch.cuda.synchronize()
    (cpu_model(x) - y).square().mean().backward()
    cpu_grads = dict(cpu_model.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient on the card"
        ref = cpu_grads[name].grad.double()
        err = float((p.grad.cpu().double() - ref).norm() / ref.norm())
        assert err <= 1e-4, f"{name}: rel l2 {err}"
    assert [fn.launches - b for fn, b in zip(launches, before)] == [2, 2]


def test_solver_on_the_card_matches_the_cpu(card):
    from neuraloperator_tpu_torch.data.datasets import ns_solver

    w0 = ns_solver.gaussian_rf_vorticity(np.random.default_rng(10_000), 3, 64)
    card_snap = ns_solver.simulate_navier_stokes_2d(w0, T=1.0, device="cuda").cpu().numpy()
    cpu_snap = ns_solver.simulate_navier_stokes_2d(w0, T=1.0, device="cpu").numpy()
    assert card_snap.shape == cpu_snap.shape == (3, 1, 64, 64)
    for b in range(3):
        err = np.linalg.norm(card_snap[b] - cpu_snap[b]) / np.linalg.norm(cpu_snap[b])
        assert err <= 1e-5, (b, err)


def test_evaluation_on_the_card_matches_the_cpu(card):
    """The published weights on 32 pairs of vorticity fields, card vs CPU."""
    from neuraloperator_tpu_torch.data.datasets import ns_solver
    from neuraloperator_tpu_torch.models import load_flagship
    from neuraloperator_tpu_torch.scripts.eval_ns_checkpoint import evaluate

    flagship = METADATA.parent
    model, processor, _ = load_flagship(flagship, "best_model_f16", device="cuda")
    cpu_model, _, _ = load_flagship(flagship, "best_model_f16", device="cpu")
    fields = ns_solver.gaussian_rf_vorticity(np.random.default_rng(3), 64, 128)[:, None]
    xs, ys = fields[:32], fields[32:]
    before = tsc.mode_contraction.launches
    on_card = evaluate(model, processor, xs, ys, 16, device="cuda")
    assert tsc.mode_contraction.launches == before + 4 * 2
    on_cpu = evaluate(cpu_model, processor, xs, ys, 16, device="cpu")
    assert on_card["pairs"] == on_cpu["pairs"] == 32
    for k in ("rel_l2", "rel_h1"):
        assert abs(on_card[k] - on_cpu[k]) <= 1e-4 * abs(on_cpu[k]), (k, on_card, on_cpu)
