"""Channel-MLP dropout, ``remat`` and ``scan_layers`` of the port's FNO
against the JAX package, on the CPU at a small size.

A flagship-shaped FNO (hidden 8 or 12, 8x8 modes, 2 or 3 layers): the JAX
model is initialised, its parameters go through ``convert`` into the port
model, and both run the same numpy inputs; the JAX side reaches the Pallas
contraction in interpret mode.

Tolerances (f32): forwards within relative l2 1e-6 of JAX's and gradients
within 1e-5 per leaf, as ``tests/test_fno.py`` holds ``remat`` to the
unrolled model (measured: 2e-7 to 6e-7); a ``Trainer`` step as
``tests/test_torch_trainer.py`` holds it (loss ``rtol=1e-5``, gradients
1e-4, updates 2**-8 under the factored policy). ``remat`` against the same
port model without it: bit for bit (the same kernels on the same inputs,
recomputed). Dropout's draws are torch's, not JAX's: the branch is held to
its distribution (the share zeroed within 5 standard deviations of the
rate over 40 000 draws, the kept values scaled by exactly ``1 / (1 - p)``).
Checkpoint files: byte for byte.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser
from jax.experimental import pallas as pl

from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.data.datasets import navier_stokes as jns
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.models import base_model as jbase
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
from neuraloperator_tpu_torch.layers import ChannelMLP
from neuraloperator_tpu_torch.layers.scan_fno_block import ScanFNOBlocks
from neuraloperator_tpu_torch.losses import H1Loss
from neuraloperator_tpu_torch.models import FNO, from_checkpoint, model_from_metadata
from neuraloperator_tpu_torch.models import save_arch_metadata
from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript
from neuraloperator_tpu_torch.training import Trainer, build_optimizer
from neuraloperator_tpu_torch.training import training_state as tts
from neuraloperator_tpu_torch.training.trainer import half_precision_forward
from test_torch_train_script import ARGS, _final, _same, jax_main, jax_script_config  # noqa: F401
from test_torch_trainer import _capture_grads, _opt_cfg, _pairs, _processors, _rel_l2

torch.set_num_threads(1)

METADATA = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2/model_metadata.json"
FWD_TOL, GRAD_TOL = 1e-6, 1e-5


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _meta(**overrides):
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update({"n_modes": [8, 8], "hidden_channels": 8, "n_layers": 2,
                                **overrides})
    return meta


def _jax_model(meta):
    from neuraloperator_tpu.models import fno as jfno

    return jfno.FNO(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in meta["init_kwargs"].items() if not isinstance(v, dict)})


def _both(meta, seed=0, res=16):
    jmodel = _jax_model(meta)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, res, res)))["params"]
    model = model_from_metadata(meta, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model


def _forward_and_grads(jmodel, params, model, x):
    """Both models' outputs and the gradients of ``mean(out ** 2)``."""
    def loss(p):
        return jnp.mean(jmodel.apply({"params": p}, jnp.asarray(x)) ** 2)

    j_out = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    j_grads = convert.flatten_flax(jax.grad(loss)(params))
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(x))
    out.square().mean().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return out.detach().numpy(), j_out, grads, j_grads


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("overrides", [
    {"remat": True},
    {"scan_layers": True, "n_layers": 3, "hidden_channels": 12},
    {"scan_layers": True, "remat": True, "n_layers": 3},
    {"channel_mlp_dropout": 0.5},
], ids=["remat", "scan", "scan-remat", "dropout"])
def test_forward_and_gradients_match_jax(jax_pallas, overrides):
    jmodel, params, model = _both(_meta(**overrides))
    out, j_out, grads, j_grads = _forward_and_grads(jmodel, params, model, _rand(1, 2, 1, 16, 16))
    assert _rel_l2(out, j_out) <= FWD_TOL
    assert set(grads) == set(j_grads)
    for name, g in grads.items():
        assert _rel_l2(g.numpy(), j_grads[name]) <= GRAD_TOL, name
    if overrides.get("scan_layers"):
        w = dict(model.named_parameters())["fno_blocks.layers.conv.w_weight"]
        assert isinstance(model.fno_blocks, ScanFNOBlocks)
        c = model.fno_blocks.layers.channel_mlp_skip.weight.shape[2]
        assert tuple(w.shape) == (model.n_layers, 2, c, c, 8, 5)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_remat_equals_the_plain_model_bit_for_bit(scan):
    """The same weights with and without ``remat``: equal outputs and
    gradients, in f32 and under the Trainer's half policy (whose bf16
    parameter copies the recompute must see)."""
    plain = model_from_metadata(_meta(scan_layers=scan), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    remat = model_from_metadata(_meta(scan_layers=scan, remat=True), device="cpu")
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_rand(2, 2, 1, 16, 16))
    for forward in (lambda m: m(x), lambda m: half_precision_forward(m, {"x": x}).float()):
        outs, grads = [], []
        for m in (plain, remat):
            m.zero_grad(set_to_none=True)
            out = forward(m)
            out.square().mean().backward()
            outs.append(out.detach())
            grads.append({n: p.grad for n, p in m.named_parameters()})
        assert torch.equal(*outs)
        for name, g in grads[0].items():
            assert torch.equal(g, grads[1][name]), name


@pytest.mark.parametrize("overrides", [
    {"channel_mlp_dropout": 0.5},
    {"scan_layers": True},
    {"scan_layers": True, "remat": True},
], ids=["dropout", "scan", "scan-remat"])
def test_one_trainer_step_matches_jax(jax_pallas, overrides):
    """One ``Trainer`` step (factored AdamW, H1) of each option against the
    JAX ``Trainer``'s: the loss, every gradient and every update."""
    meta = _meta(**overrides)
    jmodel, params, model = _both(meta)
    x, y = _pairs(2, 4)
    dp, jdp_ = _processors(x, y)
    before = {k: np.asarray(v) for k, v in convert.flatten_flax(params).items()}
    grab = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_)
    grab.params = params
    j_metrics = grab.train(jds.DataLoader(jds.TensorDataset(x, y), 4), {}, _capture_grads(),
                           training_loss=jl.H1Loss(d=2))
    j_grads = convert.flatten_flax(grab.opt_state)
    upd = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_)
    upd.params = params
    upd.train(jds.DataLoader(jds.TensorDataset(x, y), 4), {},
              jopt.build_optimizer(_opt_cfg("factored"), 1), training_loss=jl.H1Loss(d=2))
    j_after = convert.flatten_flax(upd.params)

    metrics = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu").train(
        DataLoader(TensorDataset(x, y), 4), {}, build_optimizer(_opt_cfg("factored"), 1),
        training_loss=H1Loss(d=2))
    np.testing.assert_allclose(metrics["train_err"], j_metrics["train_err"], rtol=1e-5)
    for name, p in model.named_parameters():
        assert _rel_l2(p.grad.numpy(), j_grads[name]) <= 1e-4, name
        got = p.detach().numpy() - before[name]
        assert _rel_l2(got, np.asarray(j_after[name]) - before[name]) <= 2.0 ** -8, name


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_keeps_its_share_and_scale(rate):
    """``deterministic=False`` zeroes each element with probability ``rate``
    and scales the rest by ``1 / (1 - rate)``; by default, and in every
    forward the FNO runs, it is inert, as in the JAX package."""
    mlp = ChannelMLP(4, hidden_channels=4, n_layers=1, dropout=rate, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_rand(3, 10, 4, 1000))
    plain = ChannelMLP(4, hidden_channels=4, n_layers=1, device="cpu")
    plain.load_state_dict(mlp.state_dict())
    with torch.no_grad():
        inert, want = mlp(x), plain(x)
        got = mlp(x, deterministic=False, generator=torch.Generator().manual_seed(1))
        again = mlp(x, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(inert, want) and torch.equal(got, again)
    zeroed = got == 0
    n = zeroed.numel()
    assert abs(float(zeroed.double().mean()) - rate) <= 5 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(got[~zeroed], want[~zeroed] / (1.0 - rate))
    mlp.dropout = 1.0
    assert torch.equal(mlp(x, deterministic=False), torch.zeros_like(want))


def test_scan_runs_full_precision_whatever_the_blocks_ask(jax_pallas):
    """The JAX scanned layer builds its SpectralConv without
    ``fno_block_precision``: a "mixed" scanned model computes what the
    "full" one does, in both packages."""
    jmodel, params, model = _both(_meta(scan_layers=True, fno_block_precision="mixed"))
    full = model_from_metadata(_meta(scan_layers=True), device="cpu")
    full.load_state_dict(model.state_dict())
    x = _rand(4, 2, 1, 16, 16)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        assert torch.equal(out, full(torch.from_numpy(x)))
    assert _rel_l2(out.numpy(), np.asarray(jmodel.apply({"params": params},
                                                        jnp.asarray(x)))) <= FWD_TOL


_UNSUPPORTED = {
    "norm": {"norm": "group_norm"}, "preactivation": {"preactivation": True},
    "stabilizer": {"stabilizer": "tanh"}, "resolution_scaling_factor":
        {"resolution_scaling_factor": 2}, "complex_data": {"complex_data": True},
    "factorization": {"factorization": "tucker"}, "separable": {"separable": True},
    "conv_bias_kernel>1": {"conv_bias_kernel": 3}, "use_channel_mlp=False":
        {"use_channel_mlp": False}, "fno_skip=None": {"fno_skip": None},
    "channel_mlp_skip=None": {"channel_mlp_skip": None},
}


@pytest.mark.parametrize("option", list(_UNSUPPORTED))
def test_scan_refuses_what_jax_refuses(option):
    kwargs = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=4,
                  scan_layers=True, **_UNSUPPORTED[option])
    jmodel = _jax_model({"init_kwargs": kwargs})
    with pytest.raises(ValueError) as want:
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 8, 8)))
    with pytest.raises(ValueError) as got:
        FNO(**kwargs, device="cpu")
    assert str(got.value) == str(want.value)
    assert f"support: {option};" in str(got.value)


def test_scan_refuses_per_call_overrides():
    model = FNO((4, 4), 1, 1, 4, scan_layers=True, device="cpu")
    x = torch.zeros(1, 1, 8, 8)
    for kwargs in ({"output_shape": (8, 8)}, {"n_modes": (2, 2)}):
        with pytest.raises(ValueError, match="per-call output_shape or n_modes"):
            model(x, **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FNO((4, 4), 1, 1, 4, device="cpu")(x, output_shape=(8, 8))


def _scanned_states(steps=2):
    """A scanned model's JAX params and factored optax state after ``steps``
    updates, and the port's model and AdamW holding the same values."""
    meta = _meta(scan_layers=True, n_layers=3)
    _, params, model = _both(meta, seed=3)
    tx = jopt.build_optimizer(_opt_cfg("factored"), 2)
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    params, opt_state = jax.device_get(params), jax.device_get(opt_state)
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    opt = build_optimizer(_opt_cfg("factored"), 2).bind(model.named_parameters())
    opt.load_state_dict(fser.to_state_dict(opt_state))
    return meta, params, opt_state, model, opt


def test_scanned_checkpoints_cross_between_the_packages(tmp_path):
    """The stacked leaves (the factored second moment taken over the stacked
    spectral weight's last two axes, as optax takes it) cross both ways:
    the files each package writes for one state are byte-identical, and the
    metadata sidecar rebuilds the scanned model in either package."""
    meta, params, opt_state, model, opt = _scanned_states()
    nu_row = convert.flatten_flax(fser.to_state_dict(opt_state))
    assert any(k.endswith("fno_blocks.layers.conv.w_weight") and v.shape == (3, 2, 8, 8, 8)
               for k, v in nu_row.items())
    jts.save_training_state(tmp_path / "jax", "model", params, opt_state, epoch=4)
    tts.save_training_state(tmp_path / "port", "model", model.state_dict(), opt.state_dict(),
                            epoch=4)
    for name in ("model.msgpack", "optimizer.msgpack", "manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    save_arch_metadata(model, tmp_path / "port", "model")
    rebuilt = from_checkpoint(tmp_path / "port", "model", device="cpu")
    assert isinstance(rebuilt.fno_blocks, ScanFNOBlocks)
    state, loaded, epoch = tts.load_training_state(tmp_path / "jax", "model",
                                                   rebuilt.state_dict(), opt.state_dict(),
                                                   device="cpu")
    assert epoch == 4 and int(loaded["0"]["count"]) == 2
    for name, p in model.state_dict().items():
        assert torch.equal(state[name], p), name
    # the port's sidecar rebuilds the scanned model in the JAX package
    jmodel = jbase.from_checkpoint(tmp_path / "port", "model")
    assert jmodel.scan_layers and not jmodel.remat and jmodel.channel_mlp_dropout == 0.0
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    got = jts.load_training_state(tmp_path / "port", "model", zeros)[0]
    x = jnp.asarray(_rand(6, 1, 1, 16, 16))
    with torch.no_grad():
        np.testing.assert_array_equal(
            np.asarray(jmodel.apply({"params": got}, x)),
            np.asarray(_jax_model(meta).apply({"params": params}, x)))


@pytest.mark.parametrize("overrides", [{"scan_layers": True, "remat": True},
                                       {"remat": True, "channel_mlp_dropout": 0.25}],
                         ids=["scan-remat", "remat-dropout"])
def test_metadata_round_trip_carries_the_options(tmp_path, overrides):
    model = model_from_metadata(_meta(**overrides), device="cpu")
    save_arch_metadata(model, tmp_path, "model")
    kwargs = json.loads((tmp_path / "model_metadata.json").read_text())["init_kwargs"]
    for key in ("scan_layers", "remat", "channel_mlp_dropout"):
        assert kwargs[key] == _meta(**overrides)["init_kwargs"].get(key, kwargs[key])
    rebuilt = from_checkpoint(tmp_path, "model", device="cpu")
    assert (rebuilt.scan_layers, rebuilt.remat) == (model.scan_layers, model.remat)
    jmodel = jbase.from_checkpoint(tmp_path, "model")
    assert (jmodel.scan_layers, jmodel.remat, jmodel.channel_mlp_dropout) == (
        model.scan_layers, model.remat, kwargs["channel_mlp_dropout"])


def test_the_entry_point_trains_a_scanned_model_as_jax_does(tmp_path, monkeypatch, capsys,
                                                            jax_main):
    """``train_navier_stokes --model.scan_layers true`` in both packages at
    16², warm-started from one scanned checkpoint: 2 epochs saved, then each
    package resumes the other's run for a third, to the same metrics
    (``rtol=1e-5``)."""
    data = tmp_path / "data"
    jns.generate_navier_stokes_files(data, n_train=16, n_test=8, res=16, T=0.05, seed=3)
    monkeypatch.setattr(tns, "DATA_ROOT", data)
    args = [*ARGS, "--model.scan_layers", "true"]
    from neuraloperator_tpu.models import get_model

    params = get_model(jax_script_config(args).to_dict()).init(
        jax.random.PRNGKey(4), np.zeros((1, 1, 16, 16), np.float32))["params"]
    assert "layers" in params["fno_blocks"]
    jts.save_training_state(tmp_path / "init", "best_model", params)
    first = ["--opt.n_epochs", "2", "--warm_start_from", str(tmp_path / "init")]
    want = jax_main([*args, *first, "--save_dir", str(tmp_path / "jax")], data)
    got = tscript.main([*args, *first, "--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert _final(capsys.readouterr().out).startswith("final: {'train_err'")
    _same(got, want)
    rebuilt = from_checkpoint(tmp_path / "port", "model", device="cpu")
    assert isinstance(rebuilt.fno_blocks, ScanFNOBlocks)
    resume = ["--opt.n_epochs", "3", "--resume_from_dir"]
    want = jax_main([*args, *resume, str(tmp_path / "port"), "--save_dir",
                     str(tmp_path / "port")], data)
    got = tscript.main([*args, *resume, str(tmp_path / "jax"), "--save_dir",
                        str(tmp_path / "jax"), "--device", "cpu"])
    assert "resuming from" in capsys.readouterr().out
    _same(got, want)
