"""The port's checkpoint writer and training-state files against the JAX package's.

A 2-layer, hidden-8, 8x8-mode flagship-shaped FNO: its flax parameters and
an optax state after two updates (both optimizer policies: "full" keeps f32
moments, "factored" a bf16 first moment and factored f32 second moments)
are written by both packages. Everything here is exact: the writer's bytes
equal ``flax.serialization.to_bytes``'s, a state crosses from either
package to the other and back bit for bit, and the files each package
writes for one state are byte-identical.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert, serialization
from neuraloperator_tpu_torch.training import build_optimizer
from neuraloperator_tpu_torch.training import training_state as tts
from test_torch_trainer import _both

torch.set_num_threads(1)


def _cfg(policy):
    return SimpleNamespace(learning_rate=1e-2, step_size=1, gamma=0.5, weight_decay=1e-4,
                           opt_state=policy)


def _states(policy, steps=2):
    """JAX params and optax state after ``steps`` updates, and the port's
    model and AdamW holding the same values."""
    _, params, model = _both(seed=3)
    tx = jopt.build_optimizer(_cfg(policy), 2)
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    params, opt_state = jax.device_get(params), jax.device_get(opt_state)
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    opt = build_optimizer(_cfg(policy), 2).bind(model.named_parameters())
    opt.load_state_dict(fser.to_state_dict(opt_state))
    return params, opt_state, model, opt


def _leaves(tree):
    return [np.asarray(leaf.float() if isinstance(leaf, torch.Tensor) else leaf)
            for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_writer_bytes_equal_flax_to_bytes(policy):
    params, opt_state, model, opt = _states(policy)
    assert serialization.msgpack_serialize(convert.to_flax_params(model.state_dict())) == \
        fser.to_bytes(params)
    assert serialization.msgpack_serialize(opt.state_dict()) == fser.to_bytes(opt_state)
    mu = jax.tree_util.tree_leaves(opt_state[0].mu)[0]
    assert mu.dtype == (jnp.bfloat16 if policy == "factored" else jnp.float32)


def test_writer_scalars_strings_and_chunks(monkeypatch):
    """msgpack's smallest forms for ints and strs, doubles, numpy scalars, and
    a leaf over the chunk size split as flax splits it."""
    tree = {"b": {"n": [0, 127, 128, 70000, 2**40, -1, -33, -200, -2**40], "f": 1.5,
                  "s": "x" * 40, "t": True, "none": None, "scalar": np.float32(2.5)},
            "a": {"w": np.arange(60, dtype=np.float32).reshape(6, 10), "e": {}}}
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    want = fser.msgpack_serialize(
        {"b": dict(tree["b"]), "a": {"w": tree["a"]["w"].copy(), "e": {}}}, in_place=True)
    got = serialization.msgpack_serialize(tree)
    assert got == want
    back = serialization.msgpack_restore(got)
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    assert back["b"]["n"] == tree["b"]["n"]


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_jax_saved_state_crosses_to_the_port_and_back_bit_for_bit(tmp_path, policy):
    params, opt_state, model, opt = _states(policy)
    jts.save_training_state(tmp_path / "jax", "model", params, opt_state, epoch=7)

    fresh_model, fresh_opt = _states(policy, steps=0)[2:]
    state, loaded, epoch = tts.load_training_state(
        tmp_path / "jax", "model", fresh_model.state_dict(), fresh_opt.state_dict(),
        device="cpu")
    fresh_model.load_state_dict(state)
    fresh_opt.load_state_dict(loaded)
    assert epoch == 7 and int(fresh_opt.count) == 2
    for name, p in model.state_dict().items():
        assert torch.equal(fresh_model.state_dict()[name], p), name
    tts.save_training_state(tmp_path / "port", "model", fresh_model.state_dict(),
                            fresh_opt.state_dict(), epoch=7)
    for name in ("model.msgpack", "optimizer.msgpack", "manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_port_saved_state_restores_through_jax_bit_for_bit(tmp_path, policy):
    params, opt_state, model, opt = _states(policy)
    tts.save_training_state(tmp_path, "model", model.state_dict(), opt.state_dict(), epoch=3)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    tx = jopt.build_optimizer(_cfg(policy), 2)
    got_params, got_opt, epoch = jts.load_training_state(tmp_path, "model", zeros,
                                                         tx.init(zeros))
    assert epoch == 3
    for a, b in zip(_leaves(got_params), _leaves(params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(got_opt), _leaves(opt_state)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(got_opt) == jax.tree_util.tree_structure(opt_state)


def test_optimizer_state_of_another_policy_is_refused(tmp_path):
    _, _, model, opt = _states("full")
    tts.save_training_state(tmp_path, "model", model.state_dict(), opt.state_dict())
    other = _states("factored", steps=0)[3]
    with pytest.raises(ValueError, match="keys"):
        tts.load_training_state(tmp_path, "model", model.state_dict(), other.state_dict(),
                                device="cpu")
    with pytest.raises(ValueError, match="policy"):
        other.load_state_dict(opt.state_dict())


def test_manifest_merges_and_data_processor_sidecar(tmp_path):
    """A best-model save (epoch None) keeps the periodic save's epoch, and a
    later periodic save keeps the best keys, as in the JAX package."""
    _, _, model, opt = _states("full", steps=0)
    tts.save_training_state(tmp_path, "model", model.state_dict(), opt.state_dict(), epoch=4)
    tts.save_training_state(tmp_path, "best_model", model.state_dict(), epoch=None,
                            extra_manifest={"best_metric": 0.5, "best_epoch": 4,
                                            "best_key": "16_l2"})
    assert json.loads((tmp_path / "manifest.json").read_text()) == {
        "epoch": 4, "best_metric": 0.5, "best_epoch": 4, "best_key": "16_l2"}
    tts.save_training_state(tmp_path, "model", model.state_dict(), epoch=6)
    assert json.loads((tmp_path / "manifest.json").read_text())["best_metric"] == 0.5
    assert tts.read_manifest(tmp_path)["epoch"] == 6
    # a damaged manifest is read as empty by a save, as the JAX save reads it
    (tmp_path / "manifest.json").write_text("{not json")
    tts.save_training_state(tmp_path, "model", model.state_dict(), epoch=1)
    assert tts.read_manifest(tmp_path) == {"epoch": 1}

    class Processor:
        def state_dict(self):
            return {"type": "DefaultDataProcessor", "in_normalizer": None,
                    "out_normalizer": None}

    tts.save_training_state(tmp_path / "dp", "model", model.state_dict(),
                            data_processor=Processor())
    assert json.loads((tmp_path / "dp/data_processor.json").read_text())["type"] == \
        "DefaultDataProcessor"
    assert not list(tmp_path.glob(".model.msgpack.*"))  # no temporary file left behind
