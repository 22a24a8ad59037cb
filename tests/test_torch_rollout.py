"""Rollout training, autoregressive evaluation and the rollout script against the JAX package.

A 2-layer, hidden-8, 8x8-mode flagship-shaped FNO at 16² (the JAX model's
weights, through ``convert``), seeded trajectories in which each snapshot
is a fixed smooth map of the one before, normalizers fitted by each
package on the same arrays, the H1 loss and AdamW ("full"): ``Trainer.train``
with ``rollout_steps=3``, pushforward on and off, f32 and the mixed
policy, on the loader loop and on the staged path, over 3 steps;
``evaluate(mode="autoregression")``; ``DefaultDataProcessor.feedback``;
and ``scripts/eval_ns_rollout.py``'s ``per_step_rollout_l2`` and ``main``
against the JAX script's function and its pieces. The JAX contraction runs
its plain XLA path (its Pallas kernel is the TPU's); the port runs its
kernels' plain versions on the CPU.

Tolerances:
* f32: the metrics ``rtol=1e-5`` and all parameters together within
  relative l2 1e-5 (the same f32 steps, with sums over the batch and the
  grid in another order, as ``test_torch_trainer_recipe.py`` holds them);
  the evaluations and the rollout script's figures ``rtol=1e-5``;
* the mixed policy: the metrics within 1e-3 relative (2.6e-5 measured;
  jitted XLA keeps bf16 chains in f32 between ops where the port rounds
  each, as in ``test_torch_mixed_precision.py``'s 2-epoch runs), and the
  sum of the 3 updates, all parameters together, within relative l2 0.15
  of JAX's (0.085 measured; ``test_torch_mixed_precision.py``'s bound for
  one step: a bf16 weight moves by a whole ulp or not at all);
* ``feedback``: ``rtol=1e-6`` (two elementwise f32 ops);
* the shape error: the JAX message, character for character.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.data.datasets.ns_solver import trajectories_to_windows
from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
from neuraloperator_tpu_torch.models import FNO
from neuraloperator_tpu_torch.scripts import eval_ns_rollout
from neuraloperator_tpu_torch.training import Trainer, build_optimizer
from test_torch_trainer import RES, _both, _processors, _rel_l2

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
K, BATCH = 3, 4
TOL, MIXED_TOL = 1e-5, 1e-3
MIXED = dict(weight_dtype="bfloat16", fno_block_precision="mixed")


def _trajectories(seed, n_traj, n_snap, res=RES):
    """Seeded trajectories: each snapshot a fixed smooth map of the last."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n_traj, res, res)).astype(np.float32)
    snaps = [w]
    for _ in range(n_snap - 1):
        w = (0.6 * np.roll(w, 1, axis=-1) + 0.3 * np.roll(w, -1, axis=-2) + 0.1 * w)
        snaps.append(w.astype(np.float32))
    return np.stack(snaps, axis=1)


def _cfg():
    return SimpleNamespace(learning_rate=1e-3, step_size=50, gamma=0.5, weight_decay=1e-4,
                           opt_state="full")


def _models(mixed):
    """The JAX model with its params and the port model holding the same values."""
    from test_torch_mixed_precision import _models as mixed_models

    if mixed:
        return mixed_models(**MIXED)
    jmodel, params, model = _both(0)
    return jmodel, jax.device_get(params), model


class Rollout:
    """One rollout problem for both packages: 12 windows of K+ targets."""

    def __init__(self, mixed=False):
        self.jmodel, self.params_np, self.model = _models(mixed)
        self.mixed = mixed
        self.x, self.y = trajectories_to_windows(_trajectories(1, 4, 6), K)
        self.dp, self.jdp = _processors(self.x, self.y[:, 0])

    def jax(self, pushforward, device_dataset):
        trainer = jtrainer.Trainer(model=self.jmodel, n_epochs=1, data_processor=self.jdp,
                                   mixed_precision=self.mixed)
        trainer.params = jax.tree_util.tree_map(jnp.asarray, self.params_np)
        metrics = trainer.train(
            jds.DataLoader(jds.TensorDataset(self.x, self.y), BATCH), {},
            jopt.build_optimizer(_cfg(), 3), training_loss=jl.H1Loss(d=2),
            rollout_steps=K, pushforward=pushforward, device_dataset=device_dataset)
        return trainer, metrics

    def port(self, pushforward, device_dataset):
        trainer = Trainer(model=self.model, n_epochs=1, data_processor=self.dp, device="cpu",
                          mixed_precision=self.mixed)
        metrics = trainer.train(
            DataLoader(TensorDataset(self.x, self.y), BATCH), {},
            build_optimizer(_cfg(), 3), training_loss=H1Loss(d=2),
            rollout_steps=K, pushforward=pushforward, device_dataset=device_dataset)
        return trainer, metrics


def _flat(jparams) -> dict:
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in convert.flatten_flax(jparams).items()}


def _params_rel_l2(model, jparams, init=None) -> float:
    """All parameters together against JAX's, or, given ``init``, their
    changes from it."""
    flat = _flat(jparams)
    named = {k: p.detach().float().numpy() for k, p in model.named_parameters()}
    assert set(named) == set(flat)
    names = sorted(named)
    start = _flat(init) if init is not None else {k: 0.0 for k in names}
    return _rel_l2(np.concatenate([(named[k] - start[k]).ravel() for k in names]),
                   np.concatenate([(flat[k] - start[k]).ravel() for k in names]))


@pytest.mark.parametrize("device_dataset", [False, True], ids=["loop", "staged"])
@pytest.mark.parametrize("pushforward", [True, False], ids=["pushforward", "bptt"])
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
def test_rollout_training_matches_jax(mixed, pushforward, device_dataset):
    run = Rollout(mixed)
    ref, want = run.jax(pushforward, device_dataset)
    trainer, got = run.port(pushforward, device_dataset)
    assert int(trainer.optimizer.count) == 3
    np.testing.assert_allclose(got["train_err"], want["train_err"],
                               rtol=MIXED_TOL if mixed else TOL)
    if mixed:
        assert _params_rel_l2(run.model, ref.params, init=run.params_np) <= 0.15
    else:
        assert _params_rel_l2(run.model, ref.params) <= TOL
    if device_dataset:
        # trajectories staged whole, no H1 denominator precomputed for them
        assert set(trainer.staged_step.data) == {"x", "y"}
        assert tuple(trainer.staged_step.data["y"].shape) == run.y.shape


def test_pushforward_stops_the_gradient_between_steps():
    """With pushforward only each step's own forward reaches the weights:
    the gradient differs from full backpropagation through time."""
    grads = {}
    for pushforward in (True, False):
        run = Rollout()
        trainer, _ = run.port(pushforward, False)
        grads[pushforward] = torch.cat([p.grad.ravel() for p in run.model.parameters()])
    assert _rel_l2(grads[True].numpy(), grads[False].numpy()) > 1e-3


def test_feedback_matches_jax():
    x, y = _trajectories(2, 3, 2)[:, :1], _trajectories(3, 3, 2)[:, 1:]
    dp, jdp = _processors(x, y)
    out = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    got = dp.feedback(torch.from_numpy(out)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdp.feedback(jnp.asarray(out))), rtol=1e-6)


def test_a_target_without_enough_steps_raises_the_jax_error():
    run = Rollout()
    bad_y = run.y[:, :2]  # 2 < K steps
    with pytest.raises(ValueError) as want:
        jtrainer.Trainer(model=run.jmodel, n_epochs=1).train(
            jds.DataLoader(jds.TensorDataset(run.x, bad_y), BATCH), {},
            jopt.build_optimizer(_cfg(), 3), rollout_steps=K)
    with pytest.raises(ValueError) as got:
        Trainer(model=run.model, n_epochs=1, device="cpu").train(
            DataLoader(TensorDataset(run.x, bad_y), BATCH), {}, build_optimizer(_cfg(), 3),
            rollout_steps=K)
    assert str(got.value) == str(want.value)
    assert "rollout_steps=3 needs trajectory targets" in str(got.value)


@pytest.mark.parametrize("max_steps", [None, 2])
def test_autoregressive_evaluation_matches_jax(max_steps):
    """Ragged batches (5 trajectories in batches of 2), T = 4 or capped at 2."""
    run = Rollout()
    traj = _trajectories(5, 5, 5)
    x, y = traj[:, :1], traj[:, 1:, None]
    losses = {"l2": (LpLoss(d=2), jl.LpLoss(d=2)), "h1": (H1Loss(d=2), jl.H1Loss(d=2))}
    ref = jtrainer.Trainer(model=run.jmodel, n_epochs=1, data_processor=run.jdp)
    ref.params = run.params_np
    want = ref.evaluate(None, jds.DataLoader(jds.TensorDataset(x, y), 2), "r",
                        mode="autoregression",
                        eval_losses={k: v[1] for k, v in losses.items()}, max_steps=max_steps)
    trainer = Trainer(model=run.model, n_epochs=1, data_processor=run.dp, device="cpu")
    got = trainer.evaluate(None, DataLoader(TensorDataset(x, y), 2), "r",
                           mode="autoregression",
                           eval_losses={k: v[0] for k, v in losses.items()},
                           max_steps=max_steps)
    assert set(got) == set(want) == {"r_l2", "r_h1"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    assert trainer._last_rollout_T == ref._last_rollout_T == (max_steps or 4)
    with pytest.raises(ValueError, match="unknown eval mode"):
        trainer.evaluate(None, [], "r", mode="teacher_forcing")


# ----------------------------------------------------------- the script --

SCRIPT = dict(n_modes=4, hidden_channels=8, projection_channel_ratio=4)


def _jax_rollout_script():
    spec = importlib.util.spec_from_file_location("jax_eval_ns_rollout",
                                                  ROOT / "scripts/eval_ns_rollout.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _script_models(seed=0):
    """The script's FNO in both packages, with the same weights."""
    jmodel = jfno.FNO(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8,
                      projection_channel_ratio=4)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, RES, RES)))["params"]
    model = FNO((4, 4), 1, 1, 8, projection_channel_ratio=4, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model


def test_per_step_rollout_l2_matches_the_jax_script():
    """Five trajectories in batches of 2 (a ragged last batch), 4 steps."""
    module = _jax_rollout_script()
    jmodel, params, model = _script_models()
    traj = _trajectories(6, 5, 6)
    x0, y = traj[:, 0][:, None], traj[:, 1:5][:, :, None]
    dp, jdp = _processors(traj[:, :-1].reshape(-1, 1, RES, RES),
                          traj[:, 1:].reshape(-1, 1, RES, RES))
    want = module.per_step_rollout_l2(jmodel, params, jdp, x0, y, 2)
    got = eval_ns_rollout.per_step_rollout_l2(model, dp, x0, y, 2, device="cpu")
    assert got.shape == want.shape == (4,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_the_rollout_script_matches_the_jax_script_and_fine_tunes(tmp_path, capsys):
    """``main`` on a checkpoint and raw trajectories in ``tmp_path``, with a
    one-epoch pushforward fine-tune (K=2): its figures against the JAX
    script's pieces (the JAX script reads a fixed directory of the JAX
    package), before and after the fine-tune."""
    module = _jax_rollout_script()
    jmodel, params, _ = _script_models(seed=1)
    test_traj, train_traj = _trajectories(7, 3, 14), _trajectories(8, 2, 14)
    dp, jdp = _processors(train_traj[:, :-1].reshape(-1, 1, RES, RES),
                          train_traj[:, 1:].reshape(-1, 1, RES, RES))
    ckpt = tmp_path / "ckpt"
    jts.save_training_state(ckpt, "best_model", params, data_processor=jdp)
    raw = tmp_path / "data" / "ns_raw"
    raw.mkdir(parents=True)
    np.save(raw / f"nsforcing_traj_test_{RES}.npy", test_traj)
    np.save(raw / f"nsforcing_traj_train_{RES}.npy", train_traj)
    got = eval_ns_rollout.main([
        "--save_dir", str(ckpt), "--res", str(RES), "--horizon", "3", "--n_traj", "3",
        "--batch", "2", "--n_modes", "4", "--hidden_channels", "8",
        "--pushforward_epochs", "1", "--rollout_steps", "2", "--train_traj", "2",
        "--learning_rate", "1e-3", "--data_dir", str(tmp_path / "data"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "using saved normalizers" in out and "pushforward fine-tune on 24 windows (K=2)" in out
    assert "pushforward-tuned rollout rel-l2 per step:" in out and "  t=3: " in out

    x0, y = test_traj[:, 10][:, None], test_traj[:, 11:14][:, :, None]
    want = module.per_step_rollout_l2(jmodel, params, jdp, x0, y, 2)
    np.testing.assert_allclose(got["rollout_l2"], want, rtol=TOL)
    # the JAX script's fine-tune, from the same pieces
    xw, yw = trajectories_to_windows(train_traj, 2)
    trainer = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp,
                               eval_interval=10_000)
    trainer.params = params
    want_metrics = trainer.train(
        jds.DataLoader(jds.TensorDataset(x=xw, y=yw), 2, shuffle=True, drop_last=True), {},
        jopt.adamw(1e-3), training_loss=jl.H1Loss(d=2), rollout_steps=2, pushforward=True)
    np.testing.assert_allclose(got["pushforward_metrics"]["train_err"],
                               want_metrics["train_err"], rtol=TOL)
    want_pf = module.per_step_rollout_l2(jmodel, trainer.params, jdp, x0, y, 2)
    np.testing.assert_allclose(got["pushforward_rollout_l2"], want_pf, rtol=TOL)
