"""The port's CUDA kernels and served path on an NVIDIA GPU.

Every test here needs the card (marker ``gpu``) and skips without one.
The file imports nothing of JAX, so it also runs on the GPU machine, which
has none; ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_on_card.py

Tolerances: relative l2 <= 1e-5 (f32 operands) and 1e-3 (bf16 operands)
against the plain version on the same operands; the served FNO on the card
against the same weights on the CPU: relative l2 <= 1e-5 (f32, TF32 off).
"""

import json
from pathlib import Path

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
