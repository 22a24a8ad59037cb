"""Checkpoints saved by the JAX package, loaded by the port, on the CPU.

A small FNO of the flagship's architecture is saved by the JAX package in
both of its layouts (``save_training_state``'s ``{name}.msgpack`` with a
``manifest.json``, also with float16-compressed parameters, and
``models.save_checkpoint``'s ``{name}_state_dict.msgpack``). The port
loads each through its own loaders; the loaded parameters must equal the
ones JAX's ``load_training_state`` restores exactly (a float16 value
widens to float32 without rounding), and the port's forward must match
JAX's on the same numpy input to a relative l2 of 1e-5 (f32; the
contraction and DFTs sum in another order).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.transforms import DefaultDataProcessor as JaxProcessor
from neuraloperator_tpu.data.transforms import UnitGaussianNormalizer as JaxNormalizer
from neuraloperator_tpu.models import base_model as jbase
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.training import training_state as jstate
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.models import (
    from_checkpoint,
    load_checkpoint,
    load_flagship,
    model_from_metadata,
)
from neuraloperator_tpu_torch.training import load_training_state

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2"
FORWARD_TOL = 1e-5
EPOCH = 7


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _small_flagship():
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    meta["init_kwargs"].update(n_modes=[8, 8], hidden_channels=12, n_layers=2)
    return meta


def _jax_fno(meta):
    return jfno.FNO(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["init_kwargs"].items()
        if not (isinstance(v, dict) and ("__callable__" in v or "__class__" in v))
    })


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-saved run directory: the Trainer layout (f32 and f16), the
    save_checkpoint layout, the architecture sidecars and the normalizers."""
    root = tmp_path_factory.mktemp("run")
    model = _jax_fno(_small_flagship())
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 1, 16, 16)))
    params = variables["params"]
    x, y = _rand(1, 32, 1, 16, 16), _rand(2, 32, 1, 16, 16)
    processor = JaxProcessor(JaxNormalizer(dim=[0, 2, 3]).fit(x),
                             JaxNormalizer(dim=[0, 2, 3]).fit(y))
    jbase.save_arch_metadata(model, root, "model")
    jbase.save_arch_metadata(model, root, "best_model")
    jstate.save_training_state(root, "best_model", params, epoch=EPOCH,
                               data_processor=processor)
    half = jax.tree_util.tree_map(lambda a: a.astype(jnp.float16), params)
    jstate.save_training_state(root, "best_model_f16", half)
    jbase.save_checkpoint(model, variables, root, "ckpt")
    return root, model, params


def _jax_restored(root, name, params):
    restored, _, _ = jstate.load_training_state(root, name, params)
    return restored


def _assert_forward_matches(port_model, jax_model, jax_params):
    x = _rand(4, 3, 1, 16, 16)
    expected = np.asarray(jax_model.apply({"params": jax_params}, jnp.asarray(x)))
    with torch.no_grad():
        actual = port_model(torch.from_numpy(x)).numpy()
    assert actual.shape == expected.shape
    rel = np.linalg.norm(actual - expected) / np.linalg.norm(expected)
    assert rel <= FORWARD_TOL, rel


@pytest.mark.parametrize("name", ["best_model", "best_model_f16"])
def test_training_state_loads_as_jax_restores_it(saved, name):
    root, _, params = saved
    template = model_from_metadata(_small_flagship(), device="meta").state_dict()
    state, opt_state, epoch = load_training_state(root, name, template, device="cpu")
    assert opt_state is None and epoch == EPOCH
    ref = convert.flatten_flax(_jax_restored(root, name, params))
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("name", ["best_model", "best_model_f16"])
def test_load_flagship_forward_matches_jax(saved, name):
    root, model, params = saved
    port, processor, manifest = load_flagship(root, name, device="cpu")
    assert not port.training and manifest == {"epoch": EPOCH}
    np.testing.assert_array_equal(
        np.asarray(processor.out_normalizer.std),
        json.loads((root / "data_processor.json").read_text())["out_normalizer"]["std"],
    )
    _assert_forward_matches(port, model, _jax_restored(root, name, params))


def test_from_checkpoint_with_both_layouts(saved):
    root, model, params = saved
    port = load_checkpoint(from_checkpoint(root, "ckpt", device="cpu"), root, "ckpt")
    _assert_forward_matches(port, model, params)
    port = from_checkpoint(root, "best_model", device="cpu")
    state, _, _ = load_training_state(root, "best_model", port.state_dict(), device="cpu")
    port.load_state_dict(state)
    _assert_forward_matches(port, model, params)


def test_from_checkpoint_warns_on_another_version_and_takes_extra_kwargs(tmp_path):
    meta = _small_flagship()
    meta["_version"] = "0.0.1"
    (tmp_path / "m_metadata.json").write_text(json.dumps(meta))
    with pytest.warns(UserWarning, match="version 0.0.1"):
        port = from_checkpoint(tmp_path, "m", {"hidden_channels": 6}, device="cpu")
    assert port.state_dict()["fno_blocks.fno_skip_0.weight"].shape == (6, 6)


def test_checkpoint_without_params_raises(saved, tmp_path):
    root, _, _ = saved
    (tmp_path / "x_state_dict.msgpack").write_bytes(
        (root / "best_model.msgpack").read_bytes())
    with pytest.raises(ValueError, match="no 'params'"):
        load_checkpoint(model_from_metadata(_small_flagship(), device="cpu"), tmp_path, "x")


def test_optimizer_state_is_not_ported(saved, tmp_path):
    """The optimizer state is ported now (checkpoint save/resume): as in the
    JAX package, a directory without ``optimizer.msgpack`` gives no
    optimizer state, and one whose tree does not match the template raises
    (``tests/test_torch_training_state.py`` covers the matching case)."""
    root, _, _ = saved
    template = model_from_metadata(_small_flagship(), device="meta").state_dict()
    state, opt_state, epoch = load_training_state(root, "best_model", template,
                                                  opt_state_template={}, device="cpu")
    assert opt_state is None and epoch == EPOCH and set(state) == set(template)
    shutil.copytree(root, tmp_path / "run")
    (tmp_path / "run/optimizer.msgpack").write_bytes(
        (root / "best_model_f16.msgpack").read_bytes())
    with pytest.raises(ValueError, match="keys"):
        load_training_state(tmp_path / "run", "best_model", template,
                            opt_state_template={"0": {}, "1": {}, "2": {}}, device="cpu")


def test_mismatched_checkpoint_raises(saved):
    root, _, _ = saved
    meta = _small_flagship()
    meta["init_kwargs"]["hidden_channels"] = 8
    template = model_from_metadata(meta, device="meta").state_dict()
    with pytest.raises(ValueError, match="shape"):
        load_training_state(root, "best_model", template, device="cpu")


@pytest.mark.parametrize("name", ["best_model", "ckpt"])
def test_serve_model_serves_both_layouts(saved, name, capsys):
    from neuraloperator_tpu_torch.scripts import serve_model

    root, _, _ = saved
    result = serve_model.main(["--ckpt_dir", str(root), "--name", name, "--shape", "[1,16,16]",
                               "--buckets", "[1,4]", "--probe_iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "baked saved normalizers into the endpoint" in out
    assert "bucket 1:" in out and "bucket 4:" in out
    assert sorted(result["latency_ms"]) == [1, 4]
    assert result["ragged"] == {"batch": 3, "shape": (3, 1, 16, 16), "finite": True}


@pytest.mark.parametrize("flag,what", [("--bf16", "mixed/half precision"),
                                       ("--export", "quantize/export")])
def test_serve_model_options_not_ported(saved, flag, what, capsys):
    """``--export`` raises naming its ROADMAP item; ``--bf16`` (mixed/half
    precision) is ported and serves the weights in bf16."""
    from neuraloperator_tpu_torch.scripts import serve_model

    argv = ["--ckpt_dir", str(saved[0]), "--name", "best_model", flag, "true",
            "--shape", "[1,16,16]", "--buckets", "[1,2]", "--probe_iters", "1",
            "--device", "cpu"]
    if flag == "--bf16":
        result = serve_model.main(argv)
        assert "bucket 2:" in capsys.readouterr().out
        assert result["ragged"] == {"batch": 1, "shape": (1, 1, 16, 16), "finite": True}
        return
    with pytest.raises(NotImplementedError, match=what):
        serve_model.main(argv)


@pytest.mark.slow
def test_published_f32_weights_forward_matches_jax():
    """The full-width flagship with its published f32 weights
    (``best_model.msgpack``), port against JAX at batch 1 on the CPU, with
    the checkpoint's normalizers around both."""
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    jax_model = _jax_fno(meta)
    template = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, 1, 128, 128), jnp.float32))["params"]
    params, _, _ = jstate.load_training_state(FLAGSHIP, "best_model", template)
    port, processor, manifest = load_flagship(FLAGSHIP, "best_model", device="cpu")
    assert manifest["epoch"] == 199
    std = float(np.ravel(processor.in_normalizer.std)[0])
    x = _rand(12, 1, 1, 128, 128) * std
    x_norm = processor.in_normalizer.transform(torch.from_numpy(x))
    expected = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x_norm.numpy())))
    with torch.no_grad():
        actual = port(x_norm).numpy()
    rel = np.linalg.norm(actual - expected) / np.linalg.norm(expected)
    print(f"full-width f32 flagship, port vs JAX on the CPU: rel_l2 {rel:.3e}")
    assert rel <= FORWARD_TOL, rel
