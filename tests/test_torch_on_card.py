"""The port's CUDA kernels and served path on an NVIDIA GPU.

Every test here needs the card (marker ``gpu``) and skips without one.
The file imports nothing of JAX, so it also runs on the GPU machine, which
has none; ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_on_card.py

Tolerances: relative l2 <= 1e-5 (f32 operands) and 1e-3 (bf16 operands)
for each kernel (K1, K2, K3) against its plain version on the same
operands, and two launches of a kernel on the same inputs bit for bit; the served FNO on the card against the same weights on the CPU:
relative l2 <= 1e-5 (f32, TF32 off). Gradients of a small FNO on the card
against the same model's CPU gradients: relative l2 <= 1e-4 per parameter
(f32 throughout, but a gradient sums over the batch and every grid point in
another order on each device, through 2 layers of DFT matmuls). The
Navier–Stokes solver on the card against the CPU: relative l2 <= 1e-5 per
snapshot after one record of 1000 steps (cuFFT and pocketfft round
differently: 1.7e-7 measured at 128², see chip_smoke.py's SOLVER_TOL). The evaluation of the
published weights on the card against the CPU: each figure within 1e-4
relative. Under the mixed-precision policy (bf16 pipelines on both
devices, which differ in the order of f32 sums alone), card against CPU:
one train step's loss within 1e-2 relative and its gradients together
within relative l2 5e-2, evaluation figures within 10%.
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
        # past the 16 rows a block holds; wider channels; more mode tiles than SMs
        (17, 64, 64, 2112), (32, 64, 64, 2112), (32, 128, 128, 2112), (8, 64, 64, 4 * 2112),
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
        # K2 past the 16 rows a block holds
        (17, 64, 64, 2112), (32, 64, 64, 2112),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,I,O,M", [(16, 64, 64, 2112), (17, 64, 64, 2112), (13, 66, 20, 77)])
def test_contraction_launches_are_bit_identical(card, dtype, B, I, O, M):
    """K1 and K2 sum each output in one thread over k in order: two launches
    on the same inputs agree bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + M + 11)
    w_std = (2 / (I + O)) ** 0.5 / 2 ** 0.5
    x = _parts(g, dtype, B, I, M)
    w = _parts(g, dtype, I, O, M, scale=w_std)
    grad = _parts(g, dtype, B, O, M)
    for fn, a in ((tsc.mode_contraction, x), (tsc.mode_contraction_dx, grad)):
        first = fn(*a, *w)
        again = fn(*a, *w)
        torch.cuda.synchronize()
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]), fn.__name__


@pytest.mark.parametrize(
    "dtype,B,I,O,M,dx,tile,reads,load",
    [
        (torch.float32, 1, 64, 64, 2112, False, 1, 1, "tma"),     # serve bucket 1
        (torch.float32, 8, 64, 64, 2112, False, 8, 1, "tma"),     # serve bucket 8, train
        (torch.float32, 16, 64, 64, 2112, False, 16, 1, "tma"),   # the evaluation
        (torch.bfloat16, 8, 64, 64, 2112, True, 8, 1, "tma"),     # K2
        (torch.float32, 32, 128, 128, 2112, True, 16, 2, "tma"),  # past 16 rows
        (torch.float32, 5, 7, 9, 100, False, 8, 1, "tma"),        # rows of 400 bytes
        (torch.bfloat16, 5, 7, 9, 100, False, 8, 1, "element"),   # rows of 200 bytes
        (torch.float32, 13, 66, 20, 77, True, 16, 1, "element"),
    ],
)
def test_contraction_takes_the_planned_path(card, dtype, B, I, O, M, dx, tile, reads, load):
    a = tuple(torch.zeros(B, I if not dx else O, M, device="cuda", dtype=dtype) for _ in range(2))
    w = tuple(torch.zeros(I, O, M, device="cuda", dtype=dtype) for _ in range(2))
    plan = tsc.mode_contraction_plan(*a, *w, dx=dx)
    assert (plan["batch_tile"], plan["weight_reads"], plan["load"]) == (tile, reads, load)
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


def test_graphed_staged_epoch_matches_the_eager_loop(card):
    """``device_dataset`` on the card: one eager warm-up step, then a CUDA
    graph of the step (gather, forward with K1, backward with K2 and K3,
    AdamW, the loss sum) replayed; against the loader loop over the same
    pairs in the staged epoch's order from the same weights. The same
    kernels run on the same inputs, but the graphed path precomputes the H1
    denominator and cuBLAS may pick other kernels under capture, so the
    tolerances of ``tests/test_torch_trainer_recipe.py``: the epoch's loss
    within 1e-5 relative, all parameters together within relative l2 1e-5,
    each leaf's change within 1e-4. The launch counts are the card's: one
    per layer and step, the capture not counted."""
    _graphed_against_the_loop("full", leaf_tol=1e-4)


def test_graphed_factored8_epoch_matches_the_eager_loop(card):
    """The same with the int8 first moment, whose codes and scales the
    graph updates in their captured buffers: the loss and all parameters
    together as above; each leaf's change within 2**-7, since a first
    moment within 1e-7 of a code boundary may take the next code (one code
    is at most 1/127 of its block's largest value)."""
    trainer = _graphed_against_the_loop("factored8", leaf_tol=2.0 ** -7)
    state = trainer.optimizer.state
    assert any("mu_codes" in s and s["mu_codes"].any() for s in state.values())


def _graphed_against_the_loop(opt_state: str, leaf_tol: float, **overrides):
    from types import SimpleNamespace

    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[16, 16], hidden_channels=16, n_layers=2, **overrides)
    opt = SimpleNamespace(learning_rate=1e-3, weight_decay=1e-4, step_size=50, gamma=0.5,
                          opt_state=opt_state)
    gen = np.random.default_rng(4)
    x = gen.standard_normal((40, 1, 32, 32)).astype(np.float32)
    y = (0.5 * np.roll(x, 1, axis=-1) + 0.25 * x).astype(np.float32)
    perm = np.random.default_rng(7).permutation(40)
    runs = {}
    for staged in (True, False):
        model = model_from_metadata(meta, device="cuda",
                                    generator=torch.Generator().manual_seed(0))
        init = {k: v.detach().clone() for k, v in model.named_parameters()}
        order = np.arange(40) if staged else perm
        loader = DataLoader(TensorDataset(x[order], y[order]), 8)
        trainer = Trainer(model=model, n_epochs=1, device="cuda")
        before = tsc.launch_counts()
        metrics = trainer.train(loader, {}, build_optimizer(opt, 5), training_loss=H1Loss(d=2),
                                device_dataset=staged, shuffle_seed=7)
        torch.cuda.synchronize()
        after = tsc.launch_counts()
        params = {k: v.detach().double() for k, v in model.named_parameters()}
        runs[staged] = (metrics["train_err"], params,
                        {k: after[k] - before[k] for k in after}, trainer)
    (err_g, got, launches_g, trainer_g), (err_e, want, launches_e, _) = runs[True], runs[False]
    assert trainer_g.staged_step.graph is not None
    assert int(trainer_g.optimizer.count) == 5
    k1 = 20 if overrides.get("remat") else 10  # remat runs each forward twice
    assert launches_g == launches_e == {"mode_contraction": k1, "mode_contraction_dx": 10,
                                        "mode_contraction_dw": 10}
    assert abs(err_g - err_e) <= 1e-5 * abs(err_e)
    flat_got = torch.cat([got[k].ravel() for k in sorted(got)])
    flat_want = torch.cat([want[k].ravel() for k in sorted(want)])
    assert float((flat_got - flat_want).norm() / flat_want.norm()) <= 1e-5
    for name in got:
        step_got, step_want = got[name] - init[name].double(), want[name] - init[name].double()
        assert float((step_got - step_want).norm() / step_want.norm()) <= leaf_tol, name
    return trainer_g


def test_graphed_scanned_epoch_matches_the_eager_loop(card):
    """The same with a scanned remat model: its layers run on slices of the
    stacked parameters through ``functional_call``, each a checkpoint
    recomputed in the backward, inside the capture (no RNG state is saved:
    the forward draws none). K1 runs twice per layer and step."""
    _graphed_against_the_loop("full", leaf_tol=1e-4, scan_layers=True, remat=True)


def _small_pair(**overrides):
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[16, 16], hidden_channels=16, n_layers=2, **overrides)
    model = model_from_metadata(meta, device="cuda", generator=torch.Generator().manual_seed(0))
    cpu_model = model_from_metadata(meta, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return model, cpu_model


def test_int8_serving_launches_and_matches_the_cpu(card):
    """``CompiledForward(quantize="int8")`` on the card keeps int8 codes
    there, launches K1's f32 variant once per spectral layer and request,
    and answers as on the CPU (relative l2 <= 1e-5: the same dequantized
    bf16 weights, f32 arithmetic)."""
    model, cpu_model = _small_pair()
    example = torch.zeros(1, 1, 64, 64)
    served = CompiledForward(model, example, batch_sizes=(1, 4), quantize="int8", device="cuda")
    host = CompiledForward(cpu_model, example, batch_sizes=(4,), quantize="int8", device="cpu")
    assert served._params["fno_blocks.conv_0.w_weight"][0].device.type == "cuda"
    x = torch.randn(3, 1, 64, 64, generator=torch.Generator().manual_seed(1))
    before = tsc.launch_counts(by_dtype=True)["mode_contraction"]
    y = served(x).cpu()
    after = tsc.launch_counts(by_dtype=True)["mode_contraction"]
    assert {dt: after[dt] - before[dt] for dt in after} == {"float32": 2, "bfloat16": 0}
    ref = host(x)
    assert float((y.double() - ref.double()).norm() / ref.double().norm()) <= 1e-5


_LOAD_AND_ANSWER = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = True
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
from neuraloperator_tpu_torch.serving import load_exported
forward = load_exported(sys.argv[1])
x = torch.load(sys.argv[2]).cuda()
tsc.reset_launch_counts()
torch.save(forward(x).cpu(), sys.argv[3])
print(json.dumps(tsc.launch_counts()))
"""


def test_exported_forward_answers_in_a_fresh_process(card, tmp_path):
    """An artifact exported on the card, loaded by a new process that
    switched TF32 on: K1 launched once per spectral layer, the answer within
    relative l2 1e-6 of the eager forward's (the artifact runs its matmuls
    with TF32 off, as the eager forward does by default)."""
    import os
    import subprocess
    import sys

    from neuraloperator_tpu_torch.serving import export_forward

    model, _ = _small_pair()
    path = tmp_path / "fno.pt2"
    export_forward(model, torch.zeros(1, 1, 64, 64), path=path)
    x = torch.randn(3, 1, 64, 64, generator=torch.Generator().manual_seed(2))
    torch.save(x, tmp_path / "x.pt")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _LOAD_AND_ANSWER, str(path),
                          str(tmp_path / "x.pt"), str(tmp_path / "y.pt")],
                         cwd=root, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["mode_contraction"] == 2
    with torch.no_grad():
        want = model.eval()(x.cuda()).cpu()
    got = torch.load(tmp_path / "y.pt")
    assert float((got.double() - want.double()).norm() / want.double().norm()) <= 1e-6


def test_remat_launches_k1_twice_per_layer(card):
    """A remat model's step recomputes each layer's forward in the backward:
    K1 twice per spectral layer, K2 and K3 once, and the gradients of the
    same model without remat to the bit."""
    model, _ = _small_pair(remat=True)
    plain, _ = _small_pair()
    x = torch.randn(4, 1, 64, 64, device="cuda")
    grads = []
    for m in (plain, model):
        before = tsc.launch_counts()
        m(x).square().mean().backward()
        torch.cuda.synchronize()
        after = tsc.launch_counts()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert {k: after[k] - before[k] for k in after} == {
        "mode_contraction": 4, "mode_contraction_dx": 2, "mode_contraction_dw": 2}
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_graphed_rollout_epoch_matches_the_eager_loop(card):
    """Rollout training (K=3, pushforward) on the staged set: trajectories
    staged whole and the rollout step replayed as a CUDA graph, against the
    loader loop over the same windows in the same order from the same
    weights. The same kernels on the same inputs (no H1 denominator is
    precomputed for a rollout): the epoch's loss within 1e-5 relative, all
    parameters together within relative l2 1e-5; K1, K2 and K3 launched
    once per layer and rollout step."""
    from types import SimpleNamespace

    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.data.datasets.ns_solver import trajectories_to_windows
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[16, 16], hidden_channels=16, n_layers=2)
    opt = SimpleNamespace(learning_rate=1e-3, weight_decay=1e-4, step_size=50, gamma=0.5,
                          opt_state="full")
    traj = np.random.default_rng(5).standard_normal((4, 7, 32, 32)).astype(np.float32)
    x, y = trajectories_to_windows(traj, 3)  # 16 windows of 3 steps
    perm = np.random.default_rng(7).permutation(len(x))
    runs = {}
    for staged in (True, False):
        model = model_from_metadata(meta, device="cuda",
                                    generator=torch.Generator().manual_seed(0))
        order = np.arange(len(x)) if staged else perm
        trainer = Trainer(model=model, n_epochs=1, device="cuda")
        before = tsc.launch_counts()
        metrics = trainer.train(DataLoader(TensorDataset(x[order], y[order]), 4), {},
                                build_optimizer(opt, 4), training_loss=H1Loss(d=2),
                                rollout_steps=3, device_dataset=staged, shuffle_seed=7)
        torch.cuda.synchronize()
        after = tsc.launch_counts()
        runs[staged] = (metrics["train_err"],
                        torch.cat([p.detach().double().ravel() for p in model.parameters()]),
                        {k: after[k] - before[k] for k in after}, trainer)
    (err_g, got, launches_g, trainer_g), (err_e, want, launches_e, _) = runs[True], runs[False]
    assert trainer_g.staged_step.graph is not None
    assert tuple(trainer_g.staged_step.data["y"].shape) == y.shape
    assert launches_g == launches_e == {"mode_contraction": 24, "mode_contraction_dx": 24,
                                        "mode_contraction_dw": 24}
    assert abs(err_g - err_e) <= 1e-5 * abs(err_e)
    assert float((got - want).norm() / want.norm()) <= 1e-5


def test_stochastic_rounding_draws_new_noise_at_every_replay(card):
    """A captured stochastic rounding replays with fresh noise: its generator
    is registered with the graph. Two replays on the same input round some
    elements apart, each by at most one bf16 ulp of the input; a graph that
    reused its captured offsets would give equal results."""
    from neuraloperator_tpu_torch.training import stochastic_round_to

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = 1.0 + torch.rand(1 << 16, device="cuda", generator=gen) * 2.0 ** -6
    out = torch.empty_like(x, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(stochastic_round_to(torch.bfloat16, x, gen))  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out.copy_(stochastic_round_to(torch.bfloat16, x, gen))
    graph.replay()
    first = out.float().clone()
    graph.replay()
    second = out.float()
    ulp = 2.0 ** -7  # bf16 spacing in [1, 2)
    assert not torch.equal(first, second)
    assert float((first - x).abs().max()) < ulp and float((second - x).abs().max()) < ulp


def test_a_stochastically_rounded_graphed_step_draws_new_noise(card):
    """``Trainer(stochastic_rounding=True)`` with the staged set: the
    graphed step replayed twice from one saved state (parameters, optimizer
    state and count) leaves bf16 parameters that differ where the noise
    rounded them apart, by at most one bf16 ulp, and every parameter stays
    bf16."""
    from types import SimpleNamespace

    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[16, 16], hidden_channels=16, n_layers=2)
    model = model_from_metadata(meta, device="cuda", generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(4).standard_normal((16, 1, 32, 32)).astype(np.float32)
    y = (0.5 * np.roll(x, 1, axis=-1) + 0.25 * x).astype(np.float32)
    opt = SimpleNamespace(learning_rate=1e-3, weight_decay=1e-4, step_size=50, gamma=0.5,
                          opt_state="factored", stochastic_rounding=True)
    trainer = Trainer(model=model, n_epochs=1, device="cuda", stochastic_rounding=True)
    trainer.train(DataLoader(TensorDataset(x, y), 8), {}, build_optimizer(opt, 2),
                  training_loss=H1Loss(d=2), device_dataset=True)
    staged = trainer.staged_step
    assert staged.graph is not None and staged.generators == (trainer.sr_generator,)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    optimizer = trainer.optimizer
    tensors = [*model.parameters(), optimizer.count, optimizer.lr, optimizer.bias_correction,
               *(t for s in optimizer.state.values() for t in s.values())]
    saved = [t.detach().clone() for t in tensors]
    index = torch.arange(8, device="cuda")
    results = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        staged(index)
        torch.cuda.synchronize()
        results.append(torch.cat([p.detach().float().ravel() for p in model.parameters()]))
    first, second = results
    assert not torch.equal(first, second)
    ulp = first.abs().clamp_min(1e-30) * 2.0 ** -7
    assert bool(((first - second).abs() <= ulp).all())


def _mixed_pair(meta_overrides, seed=0):
    """A small flagship-shaped model with bf16 spectral weights and "mixed"
    blocks on the card, and its copy on the CPU."""
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update({"n_modes": [16, 16], "hidden_channels": 16, "n_layers": 2,
                                "weight_dtype": "bfloat16", "fno_block_precision": "mixed",
                                **meta_overrides})
    model = model_from_metadata(meta, device="cuda",
                                generator=torch.Generator().manual_seed(seed))
    cpu_model = model_from_metadata(meta, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return model, cpu_model


def test_mixed_step_and_eval_on_the_card_match_the_cpu(card):
    """One mixed ``Trainer`` step (the half policy) and a mixed evaluation,
    card against CPU. Both pipelines round the same operands at the same
    points and differ in the order of f32 sums alone: the loss within 1e-2
    relative, the gradients together within relative l2 5e-2 (the tolerances
    of chip_smoke.py's mixed phase), the evaluation figures within 10%."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.scripts.eval_ns_checkpoint import evaluate
    from neuraloperator_tpu_torch.training import Trainer, adamw

    model, cpu_model = _mixed_pair({})
    gen = np.random.default_rng(5)
    x = gen.standard_normal((4, 1, 64, 64)).astype(np.float32)
    y = (0.5 * np.roll(x, 1, axis=-1)).astype(np.float32)
    grads, losses = {}, {}
    for device, m in (("cuda", model), ("cpu", cpu_model)):
        trainer = Trainer(model=m, n_epochs=1, device=device, mixed_precision=True)
        losses[device] = trainer.train(DataLoader(TensorDataset(x, y), 4), {}, adamw(1e-3),
                                       training_loss=H1Loss(d=2))["train_err"]
        grads[device] = {n: p.grad.detach().float().cpu() for n, p in m.named_parameters()}
    assert grads["cuda"]["fno_blocks.conv_0.w_weight"].dtype == torch.float32
    assert dict(model.named_parameters())["fno_blocks.conv_0.w_weight"].grad.dtype == \
        torch.bfloat16
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-2 * abs(losses["cpu"])
    names = sorted(grads["cpu"])
    got = torch.cat([grads["cuda"][n].ravel() for n in names]).double()
    want = torch.cat([grads["cpu"][n].ravel() for n in names]).double()
    assert float((got - want).norm() / want.norm()) <= 5e-2

    class Identity:
        def preprocess(self, sample, train=False):
            return sample

        def postprocess(self, out, sample, train=False):
            return out, sample

    figures = {device: evaluate(m.eval(), Identity(), x, y, 2, device=device,
                                mixed_precision=True)
               for device, m in (("cuda", model), ("cpu", cpu_model))}
    for k in ("rel_l2", "rel_h1"):
        assert abs(figures["cuda"][k] - figures["cpu"][k]) <= 0.1 * figures["cpu"][k], figures


def test_mixed_paths_launch_the_bf16_variants(card):
    """Under the mixed policy the forward launches K1's bf16 variant and the
    backward K2's and K3's, once per spectral layer, and no f32 variant; a
    "full" model keeps the f32 variants."""
    from neuraloperator_tpu_torch.training.trainer import half_precision_forward

    model, _ = _mixed_pair({})
    x = torch.randn(4, 1, 64, 64, device="cuda")
    before = tsc.launch_counts(by_dtype=True)
    half_precision_forward(model, {"x": x}).float().square().mean().backward()
    torch.cuda.synchronize()
    after = tsc.launch_counts(by_dtype=True)
    delta = {n: {dt: after[n][dt] - before[n][dt] for dt in after[n]} for n in after}
    assert delta == {name: {"float32": 0, "bfloat16": 2}
                     for name in ("mode_contraction", "mode_contraction_dx",
                                  "mode_contraction_dw")}
    full, _ = _mixed_pair({"weight_dtype": "float32", "fno_block_precision": "full"})
    before = tsc.launch_counts(by_dtype=True)
    with torch.no_grad():
        full(x)
    torch.cuda.synchronize()
    after = tsc.launch_counts(by_dtype=True)
    assert {dt: after["mode_contraction"][dt] - before["mode_contraction"][dt]
            for dt in ("float32", "bfloat16")} == {"float32": 2, "bfloat16": 0}
