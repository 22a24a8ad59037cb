"""The port's serving path against the JAX package's, on the CPU at small size.

Tolerances: normalizers ``rtol=1e-6, atol=0`` (the same f32 arithmetic on
the same f32 statistics); served outputs ``rtol=1e-5, atol=1e-6`` (f32).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.transforms.data_processors import (
    load_data_processor as jax_load_data_processor,
)
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.serving import CompiledForward as JaxCompiledForward
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.transforms import load_data_processor
from neuraloperator_tpu_torch.models import model_from_metadata
from neuraloperator_tpu_torch.serving import CompiledForward, _round_up_bucket

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2"


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_normalizers_match_the_jax_sidecar_reader():
    port = load_data_processor(FLAGSHIP)
    ref = jax_load_data_processor(FLAGSHIP)
    x = _rand(0, 3, 1, 16, 16)
    for norm, jnorm in ((port.in_normalizer, ref.in_normalizer),
                        (port.out_normalizer, ref.out_normalizer)):
        t = torch.from_numpy(x)
        np.testing.assert_allclose(
            norm.transform(t).numpy(), np.asarray(jnorm.transform(jnp.asarray(x))),
            rtol=1e-6, atol=0,
        )
        np.testing.assert_allclose(
            norm.inverse_transform(t).numpy(),
            np.asarray(jnorm.inverse_transform(jnp.asarray(x))),
            rtol=1e-6, atol=0,
        )
        torch.testing.assert_close(norm.inverse_transform(norm.transform(t)), t)


def test_missing_sidecar_gives_none(tmp_path):
    assert load_data_processor(tmp_path) is None
    (tmp_path / "data_processor.json").write_text(json.dumps({"type": "Other"}))
    with pytest.raises(ValueError, match="unknown data processor"):
        load_data_processor(tmp_path)


@pytest.mark.parametrize("n,bucket", [(1, 1), (2, 4), (4, 4), (5, 8)])
def test_round_up_bucket(n, bucket):
    assert _round_up_bucket(n, (1, 4, 8)) == bucket


def _small_served_pair(res=(16, 17)):
    """A small flagship-shaped FNO in both packages, same weights and normalizers."""
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    meta["init_kwargs"].update(n_modes=[8, 6], hidden_channels=8, n_layers=2)
    kwargs = {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["init_kwargs"].items()
        if not (isinstance(v, dict) and ("__callable__" in v or "__class__" in v))
    }
    jmodel = jfno.FNO(**kwargs)
    example = np.zeros((1, 1, *res), np.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(example))["params"]
    model = model_from_metadata(meta, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model, example


def test_compiled_forward_pads_and_slices_like_jax():
    jmodel, params, model, example = _small_served_pair()
    dp, jdp = load_data_processor(FLAGSHIP), jax_load_data_processor(FLAGSHIP)
    served = CompiledForward(
        model, torch.from_numpy(example), batch_sizes=(4, 1),
        preprocess_fn=dp.in_normalizer.transform,
        postprocess_fn=dp.out_normalizer.inverse_transform, device="cpu",
    )
    assert served.batch_sizes == (1, 4)
    assert set(served.compile_seconds) == {1, 4}
    jserved = JaxCompiledForward(
        jmodel, params, jnp.asarray(example), batch_sizes=(1, 4),
        preprocess_fn=jdp.in_normalizer.transform,
        postprocess_fn=jdp.out_normalizer.inverse_transform,
    )
    for n, seed in ((1, 1), (3, 2), (4, 3)):
        x = _rand(seed, n, *example.shape[1:])
        out = served(torch.from_numpy(x))
        assert out.shape == (n, 1, *example.shape[2:])
        np.testing.assert_allclose(out.numpy(), np.asarray(jserved(jnp.asarray(x))),
                                   rtol=RTOL, atol=ATOL)
        # padding rows do not leak into the answer: same as the unpadded run
        with torch.no_grad():
            direct = dp.out_normalizer.inverse_transform(
                model(dp.in_normalizer.transform(torch.from_numpy(x))))
        np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=RTOL, atol=ATOL)


def test_compiled_forward_refuses_what_it_cannot_serve():
    _, _, model, example = _small_served_pair()
    served = CompiledForward(model, torch.from_numpy(example), batch_sizes=(1, 2), device="cpu")
    with pytest.raises(ValueError, match="largest compiled bucket"):
        served(torch.zeros(3, *example.shape[1:]))
    with pytest.raises(ValueError, match="does not fit"):
        served(torch.zeros(1, 1, 8, 8))
    with pytest.raises(ValueError, match="not a compiled bucket"):
        served.latency_probe(batch_size=3)
    assert served.latency_probe(batch_size=2, iters=2) > 0
    for option in ({"quantize": "int8"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            CompiledForward(model, torch.from_numpy(example), device="cpu", **option)
    # param_dtype is ported (tests/test_torch_mixed_precision.py holds it to JAX)
    bf16 = CompiledForward(model, torch.from_numpy(example), device="cpu",
                           param_dtype=torch.bfloat16)
    assert {p.dtype for p in bf16.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_serving_then_training_in_one_process():
    """A served forward runs in inference mode and is the first to build the
    DFT matrices; a training forward and backward at the same sizes in the
    same process must still work."""
    _, _, model, example = _small_served_pair(res=(12, 20))
    CompiledForward(model, torch.from_numpy(example), batch_sizes=(2,), device="cpu")
    x = torch.from_numpy(_rand(4, 2, *example.shape[1:]))
    model.train()
    model(x).square().mean().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_compiled_forward_serves_a_snapshot_of_the_weights():
    """The served answer is fixed at construction, as the JAX class's
    device-put params are: scaling the caller's parameters by 1.1 afterwards
    changes nothing served (it moved the answer by 0.69 relative l2 when the
    live module was served), and the caller's module keeps its training
    flag."""
    _, _, model, example = _small_served_pair()
    model.train()
    served = CompiledForward(model, torch.from_numpy(example), batch_sizes=(2,), device="cpu")
    x = torch.from_numpy(_rand(5, 2, *example.shape[1:]))
    before = served(x).clone()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.1)
    assert model.training
    assert served.model is not model
    torch.testing.assert_close(served(x), before, rtol=0, atol=0)
