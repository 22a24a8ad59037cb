"""The port's Trainer against the JAX Trainer, on a small flagship-shaped FNO.

A 2-layer, hidden-8, 8x8-mode FNO with the flagship's options at 16²: the
JAX model is initialised, its parameters go through ``convert`` into the
port model, and both trainers get the same numpy batches, normalizers
fitted by each package on the same data, the H1 training loss and the
flagship's optimizer policy. The JAX side reaches the Pallas contraction
(interpret mode, backend forced to "pallas" and restored afterwards);
leaves are matched by ``convert.flatten_flax`` names.

Tolerances (f32):
* the loss of one step: ``rtol=1e-5``;
* each leaf's gradient: relative l2 <= 1e-4 (a gradient sums over the batch
  and the grid in another order in each package, through two layers of
  DFT matmuls and the H1 stencils);
* each leaf's update after one step, "full" policy: relative l2 <= 1e-4
  (the first Adam step is ``g / |g|`` up to eps, insensitive to the
  gradient's rounding); "factored" policy: relative l2 <= 2**-8, because
  the first moment is stored in bf16 and a gradient that differs in its
  last f32 bits may round one bf16 ulp (2**-8 relative) the other way;
* the metrics of a 2-epoch run (4 updates at lr 1e-3): ``rtol=1e-4``, the
  parameters differing by at most a few bf16 ulps of the updates.
"""

import functools
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.data.transforms import data_processors as jdp
from neuraloperator_tpu.data.transforms import normalizers as jnorm
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.data.transforms import DefaultDataProcessor, UnitGaussianNormalizer
from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
from neuraloperator_tpu_torch.models import model_from_metadata
from neuraloperator_tpu_torch.training import Trainer, build_optimizer

torch.set_num_threads(1)

METADATA = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2/model_metadata.json"
RES = 16


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _meta():
    meta = json.loads(METADATA.read_text())
    meta["init_kwargs"].update(n_modes=[8, 8], hidden_channels=8, n_layers=2)
    return meta


def _jax_model(meta):
    kwargs = {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["init_kwargs"].items()
        if not (isinstance(v, dict) and ("__callable__" in v or "__class__" in v))
    }
    return jfno.FNO(**kwargs)


def _pairs(seed, n):
    """Inputs and a target that is a fixed smooth function of them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 1, RES, RES)).astype(np.float32)
    y = (0.5 * np.roll(x, 1, axis=-1) + 0.25 * np.roll(x, -2, axis=-2)).astype(np.float32)
    return x, y


def _both(seed=0):
    """The JAX model with its params and the port model holding the same values."""
    meta = _meta()
    jmodel = _jax_model(meta)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, RES, RES)))["params"]
    model = model_from_metadata(meta, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model


def _processors(x, y):
    port = DefaultDataProcessor(*(UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)))
    ref = jdp.DefaultDataProcessor(
        *(jnorm.UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)))
    return port, ref


def _opt_cfg(policy):
    return SimpleNamespace(learning_rate=1e-3, step_size=50, gamma=0.5, weight_decay=1e-4,
                           opt_state=policy)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _capture_grads():
    """An optax transformation that applies nothing and keeps the gradient as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_one_trainer_step_matches_jax(jax_pallas, policy):
    jmodel, params, model = _both()
    x, y = _pairs(2, 4)
    dp, jdp_ = _processors(x, y)
    before = {k: np.asarray(v) for k, v in convert.flatten_flax(params).items()}

    # JAX: the gradient (kept by a capturing transform) and the updated params
    grab = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_)
    grab.params = params
    j_metrics = grab.train(jds.DataLoader(jds.TensorDataset(x, y), 4), {}, _capture_grads(),
                           training_loss=jl.H1Loss(d=2))
    j_grads = convert.flatten_flax(grab.opt_state)
    upd = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_)
    upd.params = params
    upd.train(jds.DataLoader(jds.TensorDataset(x, y), 4), {},
              jopt.build_optimizer(_opt_cfg(policy), 1), training_loss=jl.H1Loss(d=2))
    j_after = convert.flatten_flax(upd.params)

    trainer = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu")
    metrics = trainer.train(DataLoader(TensorDataset(x, y), 4), {},
                            build_optimizer(_opt_cfg(policy), 1), training_loss=H1Loss(d=2))
    np.testing.assert_allclose(metrics["train_err"], j_metrics["train_err"], rtol=1e-5)
    update_tol = 1e-4 if policy == "full" else 2.0 ** -8
    named = dict(model.named_parameters())
    assert set(named) == set(j_grads) == set(j_after)
    for name, p in named.items():
        assert _rel_l2(p.grad.numpy(), j_grads[name]) <= 1e-4, name
        got = p.detach().numpy() - before[name]
        want = np.asarray(j_after[name]) - before[name]
        assert _rel_l2(got, want) <= update_tol, name


def test_two_epochs_of_training_match_jax(jax_pallas):
    jmodel, params, model = _both(seed=1)
    x, y = _pairs(3, 12)
    dp, jdp_ = _processors(x[:8], y[:8])
    losses = dict(h1=(H1Loss(d=2), jl.H1Loss(d=2)), l2=(LpLoss(d=2), jl.LpLoss(d=2)))

    ref = jtrainer.Trainer(model=jmodel, n_epochs=2, data_processor=jdp_)
    ref.params = params
    want = ref.train(
        jds.DataLoader(jds.TensorDataset(x[:8], y[:8]), 4, shuffle=True, seed=5),
        {RES: jds.DataLoader(jds.TensorDataset(x[8:], y[8:]), 2)},
        jopt.build_optimizer(_opt_cfg("factored"), 2),
        training_loss=jl.H1Loss(d=2), eval_losses={k: v[1] for k, v in losses.items()},
    )
    got = Trainer(model=model, n_epochs=2, data_processor=dp, device="cpu").train(
        DataLoader(TensorDataset(x[:8], y[:8]), 4, shuffle=True, seed=5),
        {RES: DataLoader(TensorDataset(x[8:], y[8:]), 2)},
        build_optimizer(_opt_cfg("factored"), 2),
        training_loss=H1Loss(d=2), eval_losses={k: v[0] for k, v in losses.items()},
    )
    assert set(got) == set(want) == {"train_err", "epoch_time", "16_h1", "16_l2"}
    for k in ("train_err", "16_h1", "16_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["epoch_time"] > 0


def test_scheduler_and_ynorm_carve_out():
    """The per-epoch scheduler's factor reaches every update; a
    ``_loss_ynorm_sq`` key goes to the loss, never to the model, and gives
    the loss of the two-pass H1 (``rtol=1e-5``)."""
    _, _, model = _both()
    x, y = _pairs(4, 4)
    dp, _ = _processors(x, y)
    loss = H1Loss(d=2)
    ynorm = loss.ynorm_sq(dp.out_normalizer.transform(torch.from_numpy(y))).numpy()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    plain = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu").train(
        DataLoader(TensorDataset(x, y), 4), {}, build_optimizer(_opt_cfg("full")),
        training_loss=loss)

    class Halve:
        needs_metric = False
        factor = 1.0

        def step(self):
            self.factor = 0.5

    class Recording:
        def __init__(self, inner):
            self.inner, self.scales = inner, []

        def bind(self, params):
            opt = self.inner.bind(params)
            step = opt.step
            opt.step = lambda lr_scale=1.0: self.scales.append(lr_scale) or step(
                lr_scale=lr_scale)
            return opt

    model.load_state_dict(state)
    recording = Recording(build_optimizer(_opt_cfg("full")))
    carved = Trainer(model=model, n_epochs=2, data_processor=dp, device="cpu")
    first = carved.train(DataLoader(TensorDataset(x, y, _loss_ynorm_sq=ynorm), 4), {},
                         recording, scheduler=Halve(), training_loss=loss)
    assert recording.scales == [1.0, 0.5]
    model.load_state_dict(state)
    one = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu").train(
        DataLoader(TensorDataset(x, y, _loss_ynorm_sq=ynorm), 4), {},
        build_optimizer(_opt_cfg("full")), training_loss=loss)
    np.testing.assert_allclose(one["train_err"], plain["train_err"], rtol=1e-5)
    assert first["train_err"] < one["train_err"]


def test_unported_options_raise(monkeypatch):
    _, _, model = _both()
    # mixed_precision is ported (tests/test_torch_mixed_precision.py)
    assert Trainer(model=model, n_epochs=1, device="cpu", mixed_precision=True).mixed_precision
    # so is stochastic_rounding (tests/test_torch_optimizer_options.py)
    assert Trainer(model=model, n_epochs=1, device="cpu",
                   stochastic_rounding=True).sr_generator is not None
    # so are the mesh, use_distributed and zero_sharding (tests/test_torch_mesh.py,
    # tests/test_torch_zero.py): without a current mesh, use_distributed trains
    # on one device, as the JAX Trainer does
    assert Trainer(model=model, n_epochs=1, device="cpu", use_distributed=True,
                   zero_sharding=True).mesh is None
    # wandb logging is ported (tests/test_torch_optional_packages.py): without
    # the package it turns itself off, as in the JAX Trainer
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert not Trainer(model=model, n_epochs=1, device="cpu", wandb_log=True).wandb_log
    trainer = Trainer(model=model, n_epochs=1, device="cpu")
    loader = DataLoader(TensorDataset(*_pairs(5, 2)), 2)
    opt = build_optimizer(_opt_cfg("full"))
    # device_dataset, epoch_scan_chunk, save_every/save_best, resume and warm
    # start are ported (tests/test_torch_trainer_recipe.py), and so are rollout
    # training and autoregressive evaluation (tests/test_torch_rollout.py):
    # single-step targets are refused for a rollout, as the JAX Trainer refuses them
    with pytest.raises(ValueError, match="rollout_steps=2 needs trajectory targets"):
        trainer.train(loader, {}, opt, rollout_steps=2)
    with pytest.raises(TypeError, match="adamw"):
        trainer.train(loader, {}, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="unknown eval mode"):
        trainer.evaluate(None, loader, "16", mode="teacher_forcing")


def test_regularizer_is_added_to_the_loss():
    """A ``regularizer(params)`` callable, or an object with ``.loss(params)``,
    gets the flat parameter dict and its value joins every batch loss."""
    _, _, model = _both()
    x, y = _pairs(6, 4)
    dp, _ = _processors(x, y)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    seen = []

    def penalty(params):
        seen.append(sorted(params))
        return 0.5 + params["projection.b1"].square().sum()  # b1 starts at zero

    class Penalty:
        loss = staticmethod(penalty)

    errs = []
    for regularizer in (None, penalty, Penalty()):
        model.load_state_dict(state)
        errs.append(Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu").train(
            DataLoader(TensorDataset(x, y), 4), {}, build_optimizer(_opt_cfg("full")),
            regularizer=regularizer, training_loss=H1Loss(d=2))["train_err"])
    np.testing.assert_allclose(errs[1] - errs[0], 0.5, rtol=1e-5)
    np.testing.assert_allclose(errs[2], errs[1], rtol=0)
    assert seen[0] == sorted(n for n, _ in model.named_parameters())


def test_metric_sums_keep_python_float_digits():
    """``train_err`` and the eval metrics are sums over batches; the JAX
    Trainer adds Python floats. Fed 10 000 f32 batch losses of about 1e-3,
    the port's eval mean agrees with Python's float sum to 1e-12 relative
    (an f32 running sum on the device is 1.1e-6 off)."""
    values = (1e-3 * (1 + 0.1 * np.random.default_rng(11).standard_normal(10_000))).astype(
        np.float32)
    _, _, model = _both()
    trainer = Trainer(model=model, n_epochs=1, device="cpu")
    batches = [{"x": np.zeros(1, np.float32), "v": v} for v in values]
    got = trainer.evaluate(lambda batch: {"l": batch["v"]}, batches, prefix="t")["t_l"]
    want = sum(float(v) for v in values) / len(values)
    assert abs(got - want) <= 1e-12 * abs(want)
