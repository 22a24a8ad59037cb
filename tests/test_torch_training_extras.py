"""The rest of the training and data modules in the port against the JAX package.

On the CPU, with inputs drawn from numpy seeds and JAX's parameters
converted where a model is involved:

* the optimizer options: ``max_grad_norm`` in each AdamW variant (full,
  factored, factored8, ``cast_final_updates=False``, EMA) against
  ``optax.clip_by_global_norm`` chained in front, over steps that clip and
  steps that do not: parameters ``rtol=1e-6`` (the bound of
  ``tests/test_torch_optimizer.py``'s full policy) with ``atol=1e-8``: the
  global norm is a sum over the leaves in another order, so a clipped
  gradient may be scaled an f32 ulp apart, which moves an update of lr 1e-2
  by up to ~1e-9 a step, 4 steps here (that file's 1e-9 is one step's
  rounding); the factored policy's bf16 first moment moves the bound to its
  ``2**-8 * lr * steps``; ``step(closure)``;
  ``ReduceLROnPlateau`` against the JAX class and ``reduce_on_plateau``
  against optax's over a scripted metric sequence (the factors and scales
  equal, the parameters at the full policy's bound), and the state tree of
  the wrapped optimizer against JAX's;
* the incremental FNO (loss-gap and gradient criteria): the mode counts of
  every epoch equal, the metrics ``rtol=1e-4`` (``tests/test_torch_trainer.py``'s
  bound for a 2-epoch run); ``IncrementalDataProcessor`` to the bit;
  ``compute_explained_variance`` ``rtol=1e-6``;
* Tensor-GaLore (see its test for the sign question);
* ``PrefetchLoader`` (the same batches to the bit; a worker's error reaches
  the consumer), ``H5pyDataset`` on a file written here, ``profiling``;
* the three scripts on temporary files against JAX's.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fser

from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.training import optimizer as topt

torch.set_num_threads(1)

SHAPES = {
    "conv.w_weight": (2, 3, 4, 6, 5),
    "mlp.w0": (7, 3),
    "mlp.b0": (7,),
    "gate.weight": (1,),
}


def _tree(flat):
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _run_both(tx_jax, transform, scales, values=None):
    """Both optimizers on the same gradients (one scale a step, so that some
    steps clip and some do not); the parameters after each step."""
    init = _draws(0)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = transform.bind(list(params.items()))
    j_params = _tree({k: jnp.asarray(v) for k, v in init.items()})
    j_state = tx_jax.init(j_params)
    history = []
    for step, scale in enumerate(scales):
        grads = _draws(100 + step, scale=scale)
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        extra = {} if values is None else {"value": values[step]}
        opt.step(**extra)
        updates, j_state = tx_jax.update(
            _tree(grads), j_state, j_params,
            **({} if values is None else {"value": jnp.float32(values[step])}))
        j_params = optax.apply_updates(j_params, updates)
        history.append((
            {k: p.detach().float().numpy().copy() for k, p in params.items()},
            {k: np.asarray(v, np.float32) for k, v in convert.flatten_flax(j_params).items()},
        ))
    return history, opt, j_state


def _global_norm(seed, scale):
    return float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                             for g in _draws(seed, scale).values())))


VARIANTS = {
    "full": dict(),
    "factored": dict(factored_second_moment=True, mu_dtype="bf16"),
    "factored8": dict(factored_second_moment=True, mu_dtype="int8"),
    "no_final_cast": dict(cast_final_updates=False),
}


@pytest.mark.parametrize("variant", [*VARIANTS, "ema"])
def test_max_grad_norm_matches_optax(variant):
    scales = [3.0, 0.01, 2.0, 0.02]
    m = 1.0
    # the first and third steps clip, the second and fourth do not
    assert [_global_norm(100 + i, s) > m for i, s in enumerate(scales)] == [
        True, False, True, False]
    kw = dict(VARIANTS.get(variant, {}))
    mu = kw.pop("mu_dtype", None)
    jmu = {"bf16": jnp.bfloat16, "int8": "int8", None: None}[mu]
    tmu = {"bf16": torch.bfloat16, "int8": "int8", None: None}[mu]
    lr = jopt.step_lr(1e-2, 1, 0.5, 2)
    tlr = topt.step_lr(1e-2, 1, 0.5, 2)
    tx = jopt.adamw(lr, weight_decay=1e-2, max_grad_norm=m, mu_dtype=jmu, **kw)
    transform = topt.adamw(tlr, weight_decay=1e-2, max_grad_norm=m, mu_dtype=tmu, **kw)
    if variant == "ema":
        tx, transform = jopt.with_ema(tx, 0.9), topt.with_ema(transform, 0.9)
    history, opt, j_state = _run_both(tx, transform, scales)
    atol = 2.0 ** -8 * 1e-2 * len(scales) if mu == "bf16" else 1e-8
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=atol, err_msg=k)
    # the state tree is optax's: the clip's empty state in front
    got = convert.flatten_flax(opt.state_dict())
    want = convert.flatten_flax(fser.to_state_dict(j_state))
    assert set(got) == set(want)


def test_clipping_without_a_schedule_leaves_small_gradients_alone():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.adamw(0.1, max_grad_norm=10.0).bind([p])
    p.grad = torch.tensor([1e-3, 0.0, -1e-3])
    ref = topt.adamw(0.1).bind([q := torch.nn.Parameter(torch.ones(3))])
    q.grad = p.grad.clone()
    opt.step()
    ref.step()
    assert torch.equal(p, q)


def test_step_with_a_closure_follows_torch():
    """The closure runs with gradients enabled before the update, and its
    loss is returned; the update is the one of a plain step after it."""
    x = torch.linspace(-1, 1, 8)
    p = torch.nn.Parameter(torch.tensor([0.5, -0.25]))
    q = torch.nn.Parameter(p.detach().clone())
    opt, ref = topt.adamw(1e-2).bind([p]), topt.adamw(1e-2).bind([q])

    def closure():
        opt.zero_grad()
        loss = ((p[0] * x + p[1]) ** 2).mean()
        loss.backward()
        return loss

    with torch.no_grad():
        loss = opt.step(closure)
    assert loss.requires_grad is True or loss.grad_fn is not None
    ((q[0] * x + q[1]) ** 2).mean().backward()
    assert ref.step() is None
    assert torch.equal(p, q)
    np.testing.assert_allclose(float(loss), float(((0.5 * x - 0.25) ** 2).mean()), rtol=1e-6)


METRICS = [1.0, 0.9, 0.95, 0.91, 0.92, 0.9, 0.85, 0.86, 0.87, 0.88, 0.86, 0.9, 0.7, 0.71,
           0.72, 0.73]


def test_reduce_lr_on_plateau_scheduler_matches_jax():
    port = topt.ReduceLROnPlateau(factor=0.5, patience=2, threshold=1e-2, min_lr_factor=0.2)
    ref = jopt.ReduceLROnPlateau(factor=0.5, patience=2, threshold=1e-2, min_lr_factor=0.2)
    factors = []
    for metric in METRICS:
        port.step(metric)
        ref.step(metric)
        assert port.state_dict() == ref.state_dict()
        factors.append(port.factor)
    # two reductions, the second stopped at min_lr_factor
    assert 0.5 in factors and factors[-1] == 0.2 and port.needs_metric
    fresh = topt.ReduceLROnPlateau()
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()


def test_the_trainer_applies_the_plateau_factor():
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.training import Trainer

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(1, 1, 1, 1))

        def forward(self, x):
            return self.w * x

    x = np.ones((4, 1, 2, 2), np.float32)
    sched = topt.ReduceLROnPlateau(factor=0.5, patience=0, threshold=0.5)
    seen = []

    class Recording:
        def bind(self, params):
            opt = topt.adamw(0.0).bind(params)
            step = opt.step
            opt.step = lambda lr_scale=1.0: seen.append(lr_scale) or step(lr_scale=lr_scale)
            return opt

    Trainer(model=Model(), n_epochs=3, device="cpu").train(
        DataLoader(TensorDataset(x, x), 4), {}, Recording(), scheduler=sched)
    # epoch 0 sets the best; epoch 1 (lr 0, the same loss) misses it, so
    # epoch 2's update is halved
    assert seen == [1.0, 1.0, 0.5]


@pytest.mark.parametrize("variant", ["full", "factored"])
def test_reduce_on_plateau_matches_optax(variant):
    values = [1.0, 0.9, 0.95, 0.92, 0.93, 0.8, 0.81, 0.82, 0.83]
    kw = {"full": {}, "factored": dict(factored_second_moment=True)}[variant]
    tx = jopt.reduce_on_plateau(jopt.with_ema(jopt.adamw(
        jopt.step_lr(1e-2, 3, 0.5, 1), weight_decay=1e-3, max_grad_norm=1.0,
        mu_dtype=jnp.bfloat16 if kw else None, **kw), 0.9), factor=0.5, patience=2,
        rtol=1e-2, atol=1e-3)
    transform = topt.reduce_on_plateau(topt.with_ema(topt.adamw(
        topt.step_lr(1e-2, 3, 0.5, 1), weight_decay=1e-3, max_grad_norm=1.0,
        mu_dtype=torch.bfloat16 if kw else None, **kw), 0.9), factor=0.5, patience=2,
        rtol=1e-2, atol=1e-3)
    history, opt, j_state = _run_both(tx, transform, [0.05 * (i + 1) for i in range(9)], values)
    assert opt.needs_value
    atol = 2.0 ** -8 * 1e-2 * len(values) if kw else 1e-8
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=atol, err_msg=k)
    rop = j_state[1]
    for key in ("scale", "best_value", "plateau_count", "cooldown_count", "count"):
        assert float(opt.plateau_state[key]) == float(getattr(rop, key)), key
    assert float(rop.scale) == 0.25
    # the state tree is optax's chain of the three wrappers, and loads back
    got = convert.flatten_flax(opt.state_dict())
    want = convert.flatten_flax(fser.to_state_dict(j_state))
    assert set(got) == set(want)
    for name in want:
        if name.startswith("1."):
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), name)
    fresh = transform.bind([(k, torch.nn.Parameter(torch.zeros(s))) for k, s in SHAPES.items()])
    fresh.load_state_dict(fser.to_state_dict(j_state))
    assert float(fresh.plateau_state["scale"]) == 0.25 and int(fresh.count) == len(values)
    with pytest.raises(ValueError, match="value"):
        opt.step()


def test_reduce_on_plateau_refuses_bad_settings():
    for bad in (dict(factor=1.0), dict(rtol=-1.0), dict(rtol=0.0, atol=0.0), dict(rtol=2.0)):
        with pytest.raises(ValueError):
            topt.reduce_on_plateau(topt.adamw(1e-3), **bad)


# ---------------------------------------------------------------------------
# incremental FNO

def test_compute_explained_variance_matches_jax():
    from neuraloperator_tpu import utils as jutils
    from neuraloperator_tpu_torch import utils as tutils

    s = np.random.default_rng(3).random(9) * 5
    for k in (-3, -1, 0, 2, 5, 9, 12):
        np.testing.assert_allclose(tutils.compute_explained_variance(k, list(s)),
                                   jutils.compute_explained_variance(k, jnp.asarray(s)),
                                   rtol=1e-6, err_msg=str(k))


def test_incremental_data_processor_matches_jax():
    from neuraloperator_tpu.data.transforms import data_processors as jdp
    from neuraloperator_tpu.data.transforms import normalizers as jnorm
    from neuraloperator_tpu_torch.data.transforms import (
        IncrementalDataProcessor,
        UnitGaussianNormalizer,
    )

    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal((3, 1, 16, 16)).astype(np.float32) for _ in range(2))
    norms = [UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    jnorms = [jnorm.UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    kw = dict(subsampling_rates=[4, 2, 1], epoch_gap=2, dataset_indices=[2, 3])
    dp = IncrementalDataProcessor(*norms, **kw)
    ref = jdp.IncrementalDataProcessor(*jnorms, **kw)
    for epoch in range(7):
        dp.step(epoch)
        ref.step(epoch)
        assert dp.current_index == ref.current_index
        for train in (True, False):
            s = dp.preprocess({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, train)
            js = ref.preprocess({"x": jnp.asarray(x), "y": jnp.asarray(y)}, train)
            for k in ("x", "y"):
                np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
            out = s["y"] * 0.5
            np.testing.assert_array_equal(
                dp.postprocess(out, s, train)[0].numpy(),
                np.asarray(ref.postprocess(jnp.asarray(out.numpy()), js, train)[0]))
    assert [dp.current_index, s["x"].shape[-1]] == [2, 16]


def _incremental_pair(criterion):
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu_torch.models import FNO

    kw = dict(n_modes=(6, 6), max_n_modes=(8, 8), in_channels=1, out_channels=1,
              hidden_channels=8, n_layers=2)
    jmodel = JFNO(**kw)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 16, 16)))["params"]
    model = FNO(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model


@pytest.mark.parametrize("criterion", ["loss_gap", "grad"])
def test_incremental_fno_trainer_matches_jax(criterion):
    """Both trainers from the same weights on the same shuffled batches for 5
    epochs: the modes of every epoch equal, and the metrics ``rtol=1e-4``.
    The settings grow the modes: a loss gap of at most 10 (the loss is a sum
    over the batch of 8), or the gradient criterion after every 2 epochs."""
    from neuraloperator_tpu.data.datasets import tensor_dataset as jds
    from neuraloperator_tpu.losses import data_losses as jl
    from neuraloperator_tpu.training import incremental as jinc
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import adamw
    from neuraloperator_tpu_torch.training.incremental import IncrementalFNOTrainer

    jmodel, params, model = _incremental_pair(criterion)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((24, 1, 16, 16)).astype(np.float32)
    y = (0.5 * np.roll(x, 1, axis=-1) + 0.3 * np.roll(x, -1, axis=-2)).astype(np.float32)
    kw = (dict(incremental_loss_gap=True, incremental_loss_eps=10.0) if criterion == "loss_gap"
          else dict(incremental_grad=True, incremental_grad_eps=0.999,
                    incremental_grad_max_iter=1, incremental_buffer=1))
    ref = jinc.IncrementalFNOTrainer(model=jmodel, n_epochs=5, starting_n_modes=(4, 4), **kw)
    ref.params = params
    j_modes = []
    j_update = ref.incremental_update

    def record(loss, grads=None):
        j_modes.append(ref.current_n_modes)
        return j_update(loss, grads)

    ref.incremental_update = record
    want = ref.train(jds.DataLoader(jds.TensorDataset(x[:16], y[:16]), 8, shuffle=True, seed=1),
                     {16: jds.DataLoader(jds.TensorDataset(x[16:], y[16:]), 8)},
                     jopt.adamw(1e-2), training_loss=jl.LpLoss(d=2))
    ours = IncrementalFNOTrainer(model=model, n_epochs=5, starting_n_modes=(4, 4),
                                 device="cpu", **kw)
    got = ours.train(DataLoader(TensorDataset(x[:16], y[:16]), 8, shuffle=True, seed=1),
                     {16: DataLoader(TensorDataset(x[16:], y[16:]), 8)}, adamw(1e-2),
                     training_loss=LpLoss(d=2))
    assert ours.modes_by_epoch == j_modes
    assert ours.current_n_modes == ref.current_n_modes
    assert len(set(j_modes + [ref.current_n_modes])) > 1  # the modes grew
    for k in ("train_err", "16_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_incremental_trainer_needs_one_criterion():
    from neuraloperator_tpu_torch.training.incremental import IncrementalFNOTrainer

    _, _, model = _incremental_pair("loss_gap")
    for kw in ({}, dict(incremental_grad=True, incremental_loss_gap=True)):
        with pytest.raises(ValueError):
            IncrementalFNOTrainer(model=model, n_epochs=1, device="cpu", **kw)
    trainer = IncrementalFNOTrainer(model=model, n_epochs=1, device="cpu",
                                    incremental_loss_gap=True)
    assert trainer.max_modes == (8, 8) and trainer.current_n_modes == (6, 6)


def test_incremental_trainer_refuses_the_staged_step_and_runs_mixed():
    """The mode count reaches the model through the Trainer's per-call
    forward arguments, also under the bf16 policy; the staged step, one graph
    of one mode count on the card, is refused."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.training import adamw
    from neuraloperator_tpu_torch.training.incremental import IncrementalFNOTrainer

    _, _, model = _incremental_pair("loss_gap")
    x = np.random.default_rng(6).standard_normal((8, 1, 16, 16)).astype(np.float32)
    loaders = (DataLoader(TensorDataset(x, 0.5 * x), 4), {16: DataLoader(TensorDataset(x, x), 4)})
    trainer = IncrementalFNOTrainer(model=model, n_epochs=3, device="cpu", mixed_precision=True,
                                    incremental_loss_gap=True, incremental_loss_eps=100.0,
                                    starting_n_modes=(2, 2))
    with pytest.raises(ValueError, match="loader loop"):
        trainer.train(*loaders, adamw(1e-3), device_dataset=True)
    seen = []
    forward = model.forward
    model.forward = lambda x, **kw: seen.append(kw.get("n_modes")) or forward(x, **kw)
    metrics = trainer.train(*loaders, adamw(1e-3))
    # two train steps an epoch at the epoch's modes, two evaluation batches at
    # the model's; the loss gap needs two epochs' losses before it adds a mode
    assert seen == ([(2, 2)] * 2 + [None] * 2) * 2 + [(3, 3)] * 2 + [None] * 2
    assert trainer.modes_by_epoch == [(2, 2), (2, 2), (3, 3)]
    assert np.isfinite(metrics["train_err"]) and np.isfinite(metrics["16_l2"])


@pytest.mark.parametrize("criterion", ["loss_gap", "grad"])
def test_incremental_script_grows_the_modes(criterion, tmp_path, monkeypatch):
    """The example's entry point on the CPU with flags that make the modes
    grow (the flags the card's smoke run uses): the modes rise and every
    figure is finite."""
    from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
    from neuraloperator_tpu_torch.scripts import train_incremental_fno_darcy as inc

    monkeypatch.setattr(tdarcy, "DATA_ROOT", tmp_path)
    flags = (["--incremental_eps", "10"] if criterion == "loss_gap" else
             ["--criterion", "grad", "--incremental_eps", "0.999",
              "--incremental_grad_max_iter", "1", "--incremental_buffer", "1"])
    got = inc.main(["--device", "cpu", "--n_train", "32", "--n_test", "8",
                    "--n_epochs", "3", "--hidden_channels", "8"] + flags)
    assert got["modes_by_epoch"][0] == (4, 4) and got["final_modes"] > (4, 4)
    assert np.isfinite(got["train_err"]) and np.isfinite(got["16_l2"])


# ---------------------------------------------------------------------------
# Tensor-GaLore

GALORE_SHAPES = {
    "conv.w_weight": (2, 3, 4, 6, 5),  # the stored real/imaginary axis: never projected
    "core.w": (6, 8, 5),
    "mlp.w0": (7, 9),
    "mlp.b0": (7,),
}


def _sign_fixed_jax_hosvd(monkeypatch):
    """JAX's HOSVD with the port's sign convention: each singular vector's
    entry of largest magnitude positive."""
    from neuraloperator_tpu.training import tensor_galore as jgal

    plain = jgal._hosvd_factors

    def fixed(g, ranks):
        out = []
        for u in plain(g, ranks):
            idx = jnp.argmax(jnp.abs(u), axis=0)
            sign = jnp.sign(u[idx, jnp.arange(u.shape[1])])
            out.append(u * jnp.where(sign == 0, 1.0, sign))
        return out

    monkeypatch.setattr(jgal, "_hosvd_factors", fixed)


@pytest.mark.parametrize("signs", ["as_is", "fixed"])
def test_tensor_galore_matches_jax(monkeypatch, signs):
    """6 steps with a refresh every 2 (steps 1, 3, 5), rank 7 (each leaf keeps
    one mode whole, so no core is diagonal: see the next test), plain AdamW
    for the leaves that do not qualify (min dim 4). With JAX's factors as
    XLA's SVD signs them, the parameters match up to the second refresh
    (steps 1-2); with JAX's factors sign-fixed as the port fixes them, all 6
    steps. Bound: ``atol=1e-6`` on parameters of order 1 after steps of lr
    1e-2 (the two SVDs' vectors differ by ~1e-6 relative, which moves the
    projected Adam direction by as much)."""
    from neuraloperator_tpu.training import tensor_galore as jgal
    from neuraloperator_tpu_torch.training import tensor_galore as tgal

    if signs == "fixed":
        _sign_fixed_jax_hosvd(monkeypatch)
    kw = dict(rank=7, update_proj_gap=2, galore_scale=0.25, weight_decay=1e-2,
              min_dim_size_to_project=4)
    tx = jgal.tensor_galore_adamw(jopt.step_lr(1e-2, 2, 0.5, 2), **kw)
    transform = tgal.tensor_galore_adamw(topt.step_lr(1e-2, 2, 0.5, 2), **kw)
    rng = np.random.default_rng(11)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in GALORE_SHAPES.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = transform.bind(list(params.items()))
    assert [opt.qualifies(p) for p in params.values()] == [False, True, True, False]
    j_params = _tree({k: jnp.asarray(v) for k, v in init.items()})
    j_state = tx.init(j_params)
    n_steps = 6 if signs == "fixed" else 2
    for step in range(n_steps):
        grads = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in GALORE_SHAPES.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        updates, j_state = tx.update(_tree(grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        want = {k: np.asarray(v) for k, v in convert.flatten_flax(j_params).items()}
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=1e-6,
                                       err_msg=f"{k} at step {step + 1}")
    # the state tree is the JAX GaLoreState's, and loads back
    got = convert.flatten_flax(opt.state_dict())
    ref = convert.flatten_flax(fser.to_state_dict(j_state))
    assert set(got) == set(ref)
    fresh = transform.bind([(k, torch.nn.Parameter(torch.zeros(s)))
                            for k, s in GALORE_SHAPES.items()])
    fresh.load_state_dict(opt.state_dict())
    assert fresh.steps == n_steps and int(fresh.count) == n_steps


def test_a_matrix_truncated_on_both_sides_has_a_diagonal_core():
    """A matrix leaf whose two factors both truncate (rank 0.5 of 7 x 9) is
    projected at a refresh onto its own singular vectors: the core is
    diag(sigma) plus f32 rounding, and Adam's first step turns each rounding
    entry into about +-1 of the update, in JAX as in the port. Those entries
    differ between the two packages (and between the card and the CPU), so
    such a leaf matches only in what the diagonal carries: ``U^T dP V``'s
    diagonal within 1e-6, where ``dP`` is one refresh step's change."""
    from neuraloperator_tpu.training import tensor_galore as jgal
    from neuraloperator_tpu_torch.training import tensor_galore as tgal

    rng = np.random.default_rng(15)
    p0 = rng.standard_normal((7, 9)).astype(np.float32)
    g = rng.standard_normal((7, 9)).astype(np.float32)
    kw = dict(rank=0.5, update_proj_gap=2, galore_scale=0.25, min_dim_size_to_project=4)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tgal.tensor_galore_adamw(1e-2, **kw).bind([p])
    p.grad = torch.from_numpy(g)
    opt.step()
    tx = jgal.tensor_galore_adamw(1e-2, **kw)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p0)), jnp.asarray(p0))
    u, v = opt.state[p]["factors"]
    core = tgal._project(torch.from_numpy(g), (u, v))
    off = core - torch.diag_embed(torch.diagonal(core))
    assert float(off.abs().max()) < 1e-5 * float(core.abs().max())
    ours = u.T @ (p.detach() - torch.from_numpy(p0)) @ v
    theirs = u.T @ torch.from_numpy(np.asarray(upd)) @ v
    np.testing.assert_allclose(torch.diagonal(ours).numpy(), torch.diagonal(theirs).numpy(),
                               rtol=0, atol=1e-6)


def test_a_sign_flip_cancels_between_refreshes():
    """The same gradients through factors whose signs differ give the same
    update until the next refresh."""
    from neuraloperator_tpu_torch.training import tensor_galore as tgal

    g = torch.from_numpy(np.random.default_rng(12).standard_normal((6, 8, 5)).astype(np.float32))
    factors = tgal._hosvd_factors(g, (3, 4, 2))
    flipped = [f * torch.where(torch.arange(f.shape[1]) % 2 == 0, 1.0, -1.0) for f in factors]
    for fs in (factors, flipped):
        core = tgal._project(g, fs)
        upd = core / (core.abs() + 1e-8)  # a first Adam step in the core
        back = tgal._unproject(upd, fs)
        if fs is factors:
            first = back
    torch.testing.assert_close(back, first, rtol=0, atol=1e-6)
    for f in factors:  # orthonormal columns, each with its largest entry positive
        torch.testing.assert_close(f.T @ f, torch.eye(f.shape[1]), rtol=0, atol=1e-5)
        assert bool((f.gather(0, f.abs().argmax(0, keepdim=True)) > 0).all())


def test_tensor_galore_projector_matches_jax(monkeypatch):
    from neuraloperator_tpu.training import tensor_galore as jgal
    from neuraloperator_tpu_torch.training import tensor_galore as tgal

    _sign_fixed_jax_hosvd(monkeypatch)
    rng = np.random.default_rng(13)
    ours, ref = tgal.TensorGaLoreProjector(7, update_proj_gap=2, scale=0.5), \
        jgal.TensorGaLoreProjector(7, update_proj_gap=2, scale=0.5)
    for _ in range(3):
        g = rng.standard_normal((6, 8, 5)).astype(np.float32)
        # within 1e-5 of the largest entry: the two SVDs' vectors ~1e-6 apart
        core, jcore = ours.project(torch.from_numpy(g)), ref.project(jnp.asarray(g))
        scale = float(np.abs(np.asarray(jcore)).max())
        np.testing.assert_allclose(core.numpy(), np.asarray(jcore), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(ours.project_back(core).numpy(),
                                   np.asarray(ref.project_back(jcore)), rtol=0,
                                   atol=1e-5 * scale)
    with pytest.raises(RuntimeError):
        tgal.TensorGaLoreProjector(0.5).project_back(core)


def test_tensor_galore_trains_an_fno_through_the_trainer():
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import Trainer
    from neuraloperator_tpu_torch.training.tensor_galore import tensor_galore_adamw

    _, _, model = _incremental_pair("loss_gap")
    rng = np.random.default_rng(14)
    x = rng.standard_normal((8, 1, 16, 16)).astype(np.float32)
    opt = tensor_galore_adamw(1e-2, rank=0.5, update_proj_gap=2, min_dim_size_to_project=8)
    for device_dataset in (False, True):
        metrics = Trainer(model=model, n_epochs=3, device="cpu").train(
            DataLoader(TensorDataset(x, 0.5 * x), 4), {16: DataLoader(TensorDataset(x, x), 4)},
            opt, training_loss=LpLoss(d=2), device_dataset=device_dataset)
        assert np.isfinite(metrics["train_err"]) and np.isfinite(metrics["16_l2"])


# ---------------------------------------------------------------------------
# data pipeline and profiling

def test_prefetch_loader_gives_the_loader_batches():
    from neuraloperator_tpu_torch.data.datasets import DataLoader, PrefetchLoader, TensorDataset

    rng = np.random.default_rng(16)
    x, y = rng.standard_normal((10, 1, 4, 4)), rng.standard_normal((10, 1, 4, 4))
    plain = DataLoader(TensorDataset(x, y), 3, shuffle=True, seed=2)
    pre = PrefetchLoader(DataLoader(TensorDataset(x, y), 3, shuffle=True, seed=2), depth=2,
                         device="cpu")
    assert len(pre) == len(plain) == 4
    for _ in range(2):  # two epochs: the shuffle advances the same way
        got, want = list(pre), list(plain)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in b:
                assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
                np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_prefetch_loader_raises_the_worker_error_after_its_batches():
    from neuraloperator_tpu_torch.data.datasets import PrefetchLoader

    def broken():
        yield {"x": np.zeros(2)}
        raise KeyError("bad sample")

    seen = []
    with pytest.raises(KeyError, match="bad sample"):
        for batch in PrefetchLoader(broken(), device="cpu"):
            seen.append(batch)
    assert len(seen) == 1
    with pytest.raises(ValueError):
        PrefetchLoader([], depth=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP: distribution"):
        PrefetchLoader([], mesh=object(), device="cpu")


def test_prefetch_loader_stopped_early_ends_its_worker():
    import threading

    from neuraloperator_tpu_torch.data.datasets import PrefetchLoader

    before = threading.active_count()
    batches = ({"x": np.full(2, i)} for i in range(100))
    for i, batch in enumerate(PrefetchLoader(batches, depth=2, device="cpu")):
        assert int(batch["x"][0]) == i
        if i == 3:
            break
    assert threading.active_count() == before
    assert int(next(batches)["x"][0]) < 10  # the worker stopped drawing


def test_h5py_dataset_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from neuraloperator_tpu.data.datasets.hdf5_dataset import H5pyDataset as JH5
    from neuraloperator_tpu_torch.data.datasets import H5pyDataset

    rng = np.random.default_rng(17)
    path = tmp_path / "pairs.h5"
    with h5py.File(path, "w") as f:
        f["x"] = rng.standard_normal((5, 8, 8))
        f["y"] = rng.standard_normal((5, 8, 8)).astype(np.float32)
    for kw in (dict(), dict(subsampling_rate=2, n_samples=3),
               dict(transform_x=lambda a: a * 2, transform_y=lambda a: a - 1)):
        ours, ref = H5pyDataset(path, **kw), JH5(path, **kw)
        assert len(ours) == len(ref)
        for i in range(len(ours)):
            a, b = ours[i], ref[i]
            for k in ("x", "y"):
                assert a[k].dtype == np.float32 and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
        # a sample's first axis is taken for its channels: subsampling skips it
        assert ours[0]["x"].shape == ((1, 8, 4) if kw.get("subsampling_rate") else (1, 8, 8))
        ours.close()
        ref.close()


def test_flops_per_fno_step_matches_jax():
    from neuraloperator_tpu.training import profiling as jprof
    from neuraloperator_tpu_torch.training import profiling as tprof

    for kw in (dict(batch=8, resolution=128, n_modes=(64, 64), hidden_channels=64, n_layers=4,
                    projection_ratio=4),
               dict(batch=2, resolution=[16, 32], n_modes=(8, 12), hidden_channels=8,
                    n_layers=2, in_channels=3, out_channels=2, training=False),
               dict(batch=4, resolution=64, n_modes=(16,), hidden_channels=24, n_layers=3)):
        assert tprof.flops_per_fno_step(**kw) == jprof.flops_per_fno_step(**kw)


def test_throughput_meter_and_trace(tmp_path):
    from neuraloperator_tpu_torch.training import ThroughputMeter, trace

    meter = ThroughputMeter(warmup_steps=2)
    assert meter.steps_per_sec is None
    for _ in range(5):
        meter.step(n_samples=4)
    assert meter.steps_per_sec > 0 and meter.samples_per_sec > 0
    with trace(tmp_path / "run") as logdir:
        torch.fft.rfft2(torch.ones(4, 16, 16)).abs().sum()
    text = (tmp_path / "run" / "trace.json").read_text()
    assert logdir == str(tmp_path / "run") and "traceEvents" in text and "fft" in text


# ---------------------------------------------------------------------------
# the scripts against JAX's

def _jax_script(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_test_from_config_matches_jax(monkeypatch, capsys):
    import re
    import sys

    from neuraloperator_tpu_torch.scripts import test_from_config

    flags = ["--model.hidden_channels", "8", "--model.n_modes", "[4,4]", "--model.n_layers", "2"]
    monkeypatch.setattr(sys, "argv", ["test_from_config.py", *flags])
    _jax_script("test_from_config").main()
    want = capsys.readouterr().out
    test_from_config.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    pattern = r"model (\w+): out (\(.*\)), loss ([\d.]+), (\d+) gradient leaves"
    (jname, jshape, jloss, jleaves), = re.findall(pattern, want)
    (name, shape, loss, leaves), = re.findall(pattern, got)
    assert (name, shape.replace(" ", ""), leaves) == (jname, jshape.replace(" ", ""), jleaves)
    assert np.isfinite(float(loss)) and float(loss) > 0


def test_merge_ns_train_data_matches_jax(tmp_path, monkeypatch, capsys):
    import sys

    from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
    from neuraloperator_tpu_torch.scripts import merge_ns_train_data

    rng = np.random.default_rng(18)

    def write(folder, n, offset):
        folder.mkdir(parents=True)
        torch.save({"x": torch.from_numpy(rng.standard_normal((n, 8, 8)).astype(np.float32)),
                    "y": torch.from_numpy(np.full((n, 8, 8), offset, np.float32))},
                   folder / "nsforcing_train_8.pt")

    write(tmp_path / "jax", 5, 0.0)
    write(tmp_path / "ext", 3, 1.0)
    (tmp_path / "port").mkdir()
    (tmp_path / "port" / "nsforcing_train_8.pt").write_bytes(
        (tmp_path / "jax" / "nsforcing_train_8.pt").read_bytes())
    args = ["--ext-dir", str(tmp_path / "ext"), "--res", "8", "--shuffle-seed", "5"]
    module = _jax_script("merge_ns_train_data")
    monkeypatch.setattr(module, "DATA_DIR", tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["merge_ns_train_data.py", *args])
    module.main()
    monkeypatch.setattr(tns, "DATA_ROOT", tmp_path / "port")
    merge_ns_train_data.main(args)
    out = capsys.readouterr().out.splitlines()
    assert [line.split(" at ")[0] for line in out] == ["merged 5 + 3 -> 8 pairs"] * 2
    got, want = (torch.load(tmp_path / d / "nsforcing_train_8.pt") for d in ("port", "jax"))
    for k in ("x", "y"):
        assert torch.equal(got[k], want[k])
    assert sorted(got["y"][:, 0, 0].tolist()) == [0.0] * 5 + [1.0] * 3


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_compress_checkpoint_matches_jax(tmp_path, monkeypatch, capsys, dtype):
    """The compressed file byte for byte the JAX script's (the same round to
    nearest even of the same f32 leaves, in flax's layout); the
    equivalence number within 1e-2 relative of JAX's (both are the distance
    between two outputs of the same weights, each package's forward a few
    f32 ulps from the other's, divided by the storage rounding's
    2**-9 (bf16) or 2**-12 (f16))."""
    import json
    import sys

    import jax
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.models.base_model import save_checkpoint as jsave
    from neuraloperator_tpu.training import training_state as jts
    from neuraloperator_tpu_torch.scripts import compress_checkpoint

    jmodel = JFNO(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)
    params = jmodel.init(jax.random.PRNGKey(6), jnp.zeros((1, 1, 16, 16)))["params"]
    for run in ("jax", "port"):
        jts.save_training_state(tmp_path / run, "best_model", params)
        jsave(jmodel, params, tmp_path / run, "best_model")  # the metadata sidecar
    base = ["--name", "best_model", "--spatial", "16", "--batch", "2", "--dtype", dtype]
    monkeypatch.setattr(sys, "argv", ["compress_checkpoint.py", "--dir", str(tmp_path / "jax"),
                                      *base])
    _jax_script("compress_checkpoint").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = compress_checkpoint.main(["--dir", str(tmp_path / "port"), *base, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    name = f"best_model_{dtype}.msgpack"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert got["in_bytes"] == want["in_bytes"] and got["out_bytes"] == want["out_bytes"]
    key = f"eval_rel_l2_{dtype}_vs_f32"
    assert 0 < got[key] < 1e-2
    np.testing.assert_allclose(got[key], want[key], rtol=1e-2)
    only = compress_checkpoint.main(["--dir", str(tmp_path / "port"), *base, "--no-eval",
                                     "--device", "cpu"])
    assert key not in only
