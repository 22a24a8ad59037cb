"""The flagship recipe's Trainer options in the port against the JAX Trainer.

A 2-layer, hidden-8, 8x8-mode flagship-shaped FNO at 16², the same weights
(the JAX model's, through ``convert``), the same numpy pairs and
normalizers fitted by each package on them, the H1 training loss and the
flagship's factored AdamW: the staged dataset (``device_dataset``, with the
H1 denominator precomputed over the staged set) and its chunked epochs,
``save_every`` and ``save_best``, resume from either package's checkpoint,
warm start with and without the optimizer state, and a resumed run that
keeps its stored best. The JAX contraction runs its plain XLA path (its
Pallas kernel is the TPU's); the port runs its kernels' plain versions on
the CPU.

Tolerances: metrics ``rtol=1e-5``; all parameters together within
relative l2 1e-5; and each leaf's change from its initial value (its sum
of updates) within relative l2 1e-4 under the "full" policy and 2**-8
under the "factored" one. Both packages run the same f32 steps, but the
gradients sum over the batch and the grid in another order (1e-7 relative
per sum), and Adam's update of a leaf whose gradient is tiny against eps
is sensitive to that: after 6 to 8 steps the largest leaf difference
measured 1.2e-5 (the projection's scalar output bias, which starts at
zero) under "full". Under "factored" the first moment is stored in bf16,
and an element whose moment lies within an ulp of a bf16 rounding boundary
rounds the other way in one package, moving its update by 2**-8 of itself
(the bound of ``test_torch_trainer.py``'s one-step update; 1.5e-4
measured). Files read back are held bit for bit.
"""

import json
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
from neuraloperator_tpu_torch.models import from_checkpoint
from neuraloperator_tpu_torch.serialization import read_msgpack
from neuraloperator_tpu_torch.training import (
    Trainer,
    adamw,
    build_optimizer,
    load_training_state,
)
from test_torch_trainer import RES, _both, _opt_cfg, _pairs, _processors, _rel_l2

torch.set_num_threads(1)

BATCH = 8
TOL = 1e-5


class Run:
    """One problem for both packages: weights, pairs, processors, losses."""

    def __init__(self, seed=0, n=32, policy="full"):
        self.jmodel, params, self.model = _both(seed)
        self.params_np = jax.device_get(params)
        self.state0 = {k: v.clone() for k, v in self.model.state_dict().items()}
        self.x, self.y = _pairs(seed + 10, n + BATCH)
        self.n = n
        self.dp, self.jdp = _processors(self.x[:n], self.y[:n])
        self.policy = policy

    def loaders(self, jax_side: bool, shuffle: bool):
        ds, dl = (jds.TensorDataset, jds.DataLoader) if jax_side else (TensorDataset, DataLoader)
        n = self.n
        return (dl(ds(self.x[:n], self.y[:n]), BATCH, shuffle=shuffle, seed=5),
                {RES: dl(ds(self.x[n:], self.y[n:]), BATCH)})

    def jax(self, n_epochs, shuffle=False, eval_interval=1, **train_kw):
        trainer = jtrainer.Trainer(model=self.jmodel, n_epochs=n_epochs,
                                   data_processor=self.jdp, eval_interval=eval_interval)
        # a copy: the JAX train step donates (deletes) the params it is given
        trainer.params = jax.tree_util.tree_map(jnp.asarray, self.params_np)
        h1, l2 = jl.H1Loss(d=2), jl.LpLoss(d=2)
        metrics = trainer.train(*self.loaders(True, shuffle),
                                jopt.build_optimizer(_opt_cfg(self.policy), self.n // BATCH),
                                training_loss=h1, eval_losses={"h1": h1, "l2": l2},
                                **train_kw)
        return trainer, metrics

    def port(self, n_epochs, shuffle=False, eval_interval=1, fresh=True, **train_kw):
        if fresh:
            self.model.load_state_dict(self.state0)
        trainer = Trainer(model=self.model, n_epochs=n_epochs, data_processor=self.dp,
                          eval_interval=eval_interval, device="cpu")
        h1, l2 = H1Loss(d=2), LpLoss(d=2)
        metrics = trainer.train(*self.loaders(False, shuffle),
                                build_optimizer(_opt_cfg(self.policy), self.n // BATCH),
                                training_loss=h1, eval_losses={"h1": h1, "l2": l2},
                                **train_kw)
        return trainer, metrics


def _same_metrics(got, want):
    assert set(got) == set(want)
    for k in got:
        if k != "epoch_time":
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


def _same_params(model, jparams, run):
    flat = {k: np.asarray(v) for k, v in convert.flatten_flax(jparams).items()}
    named = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert set(named) == set(flat)
    assert _rel_l2(np.concatenate([named[k].ravel() for k in sorted(named)]),
                   np.concatenate([flat[k].ravel() for k in sorted(named)])) <= TOL
    init = convert.flatten_flax(run.params_np)
    update_tol = 1e-4 if run.policy == "full" else 2.0 ** -8
    for name, p in named.items():
        assert _rel_l2(p - init[name], flat[name] - init[name]) <= update_tol, name


def test_device_dataset_with_ynorm_precompute_matches_jax():
    """The staged path: the loader's batches staged in its order, each epoch
    in ``default_rng(shuffle_seed)``'s order, the H1 denominator of every
    staged sample computed once, the step count on the optimizer."""
    run = Run(seed=0, policy="factored")
    ref, want = run.jax(2, device_dataset=True, shuffle_seed=7)
    trainer, got = run.port(2, device_dataset=True, shuffle_seed=7)
    _same_metrics(got, want)
    _same_params(run.model, ref.params, run)
    staged = trainer.staged_step
    assert staged is not None and staged.graph is None  # the CPU runs the step eagerly
    assert set(staged.data) == {"x", "y", "_loss_ynorm_sq"}
    assert staged.data["_loss_ynorm_sq"].shape == (run.n, 1)
    assert int(trainer.optimizer.count) == int(ref.opt_state[0].count) == 2 * run.n // BATCH


@pytest.mark.parametrize("n, chunk", [(32, 2), (40, 2)], ids=["divisible", "drop_last"])
def test_epoch_scan_chunk_matches_jax(n, chunk):
    """Equal chunks of ``nb_total // k_chunks`` steps; 40 samples are 5
    batches, which a chunk of 2 runs as 3 chunks of 1 step, 2 batches
    dropped; ``train_err`` is the mean of the chunk means."""
    run = Run(seed=1, n=n)
    ref, want = run.jax(2, device_dataset=True, epoch_scan_chunk=chunk, shuffle_seed=7)
    trainer, got = run.port(2, device_dataset=True, epoch_scan_chunk=chunk, shuffle_seed=7)
    _same_metrics(got, want)
    _same_params(run.model, ref.params, run)
    assert int(trainer.optimizer.count) == int(ref.opt_state[0].count)
    if n == 32:  # divisible: the chunks replay the whole epoch's order
        chunked = {k: v.clone() for k, v in run.model.state_dict().items()}
        run.port(2, device_dataset=True, shuffle_seed=7)
        for k, v in run.model.state_dict().items():
            torch.testing.assert_close(v, chunked[k], rtol=0, atol=1e-6)


def test_save_every_save_best_and_sidecars(tmp_path):
    run = Run(seed=2)
    ref, want = run.jax(2, save_every=1, save_best=f"{RES}_l2", save_dir=tmp_path / "jax")
    trainer, got = run.port(2, save_every=1, save_best=f"{RES}_l2", save_dir=tmp_path / "port")
    _same_metrics(got, want)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "best_model.msgpack", "best_model_metadata.json", "data_processor.json",
        "manifest.json", "model.msgpack", "model_metadata.json", "optimizer.msgpack"]
    jm, pm = (json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("jax", "port"))
    assert pm["epoch"] == jm["epoch"] == 1 and pm["best_key"] == f"{RES}_l2"
    assert pm["best_epoch"] == jm["best_epoch"]
    np.testing.assert_allclose(pm["best_metric"], jm["best_metric"], rtol=TOL)
    assert json.loads((tmp_path / "port/data_processor.json").read_text()) == \
        json.loads((tmp_path / "jax/data_processor.json").read_text())
    # the best weights, read back by the JAX package and rebuilt by the port
    best_jax = jts.load_training_state(tmp_path / "jax", "best_model", ref.params)[0]
    best_port = jts.load_training_state(tmp_path / "port", "best_model", ref.params)[0]
    for a, b in zip(jax.tree_util.tree_leaves(best_port), jax.tree_util.tree_leaves(best_jax)):
        assert _rel_l2(a, b) <= TOL
    rebuilt = from_checkpoint(tmp_path / "port", "best_model", device="cpu")
    rebuilt.load_state_dict(load_training_state(tmp_path / "port", "best_model",
                                                rebuilt.state_dict(), device="cpu")[0])
    _same_params(rebuilt, best_jax, run)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_crosses_between_the_packages(tmp_path, direction):
    """Two epochs saved by one package, two more resumed by the other, against
    the first package resuming itself: weights, optimizer state and epoch
    carry over (the loader loop, shuffled from one seed in both)."""
    run = Run(seed=3, policy="full" if direction == "jax_to_port" else "factored")
    first, resumed = (run.jax, run.port) if direction == "jax_to_port" else (run.port, run.jax)
    first(2, shuffle=True, save_every=1, save_dir=tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    if direction == "jax_to_port":
        ref, want = run.jax(4, shuffle=True, resume_from_dir=tmp_path / "a")
        trainer, got = run.port(4, shuffle=True, resume_from_dir=tmp_path / "b")
        ref_params, port_model = ref.params, run.model
    else:
        trainer, want = run.port(4, shuffle=True, fresh=False, resume_from_dir=tmp_path / "a")
        ref_params = convert.to_flax_params(run.model.state_dict())
        port_model = run.model
        ref, got = run.jax(4, shuffle=True, resume_from_dir=tmp_path / "b")
        port_model.load_state_dict(convert.convert_flax_params(
            jax.device_get(ref.params), port_model.state_dict(), device="cpu"))
    assert trainer.start_epoch == ref.start_epoch == 2
    assert int(trainer.optimizer.count) == int(ref.opt_state[0].count) == 4 * run.n // BATCH
    _same_metrics(got, want)
    _same_params(port_model, ref_params, run)


def _opt_arrays(tree) -> dict:
    """An optax state tree (either package's) as {dotted name: f32 array}."""
    return {k: np.asarray(convert.as_tensor(v).float())
            for k, v in convert.flatten_flax(tree).items()}


def test_warm_start_params_only_and_with_the_optimizer(tmp_path):
    run = Run(seed=4, policy="factored")
    src = tmp_path / "src"
    run.port(2, save_every=1, save_best=f"{RES}_l2", save_dir=src)
    saved_opt = _opt_arrays(read_msgpack(src / "optimizer.msgpack"))

    # lr 0: the weights are the donor's best, the epoch fresh
    trainer = Trainer(model=run.model, n_epochs=1, data_processor=run.dp, device="cpu")
    trainer.train(*run.loaders(False, False), adamw(0.0), training_loss=H1Loss(d=2),
                  warm_start_from=src)
    assert trainer.start_epoch == 0
    best = load_training_state(src, "best_model", run.model.state_dict(), device="cpu")[0]
    for k, v in run.model.state_dict().items():
        torch.testing.assert_close(v, best[k], rtol=1e-6, atol=0)

    # with the optimizer: the donor's state, nothing trained after it
    trainer = Trainer(model=run.model, n_epochs=0, device="cpu")
    trainer.train(*run.loaders(False, False), build_optimizer(_opt_cfg("factored")),
                  warm_start_from=src, warm_start_name="model", warm_start_opt=True)
    got = _opt_arrays(trainer.optimizer.state_dict())
    assert trainer.start_epoch == 0 and set(got) == set(saved_opt)
    for k in got:
        np.testing.assert_array_equal(got[k], saved_opt[k], err_msg=k)
    # the JAX Trainer warm-starts from the port's files to the same state
    jt = jtrainer.Trainer(model=run.jmodel, n_epochs=0)
    jt.params = jax.tree_util.tree_map(jnp.asarray, run.params_np)
    jt.train(*run.loaders(True, False), jopt.build_optimizer(_opt_cfg("factored"), 4),
             warm_start_from=src, warm_start_name="model", warm_start_opt=True)
    theirs = _opt_arrays(fser.to_state_dict(jax.device_get(jt.opt_state)))
    assert set(theirs) == set(got)
    for k in got:
        np.testing.assert_array_equal(got[k], theirs[k], err_msg=k)

    # a donor of another policy, then one without optimizer.msgpack: warn, fresh state
    for policy in ("full", "factored"):
        if policy == "factored":
            (src / "optimizer.msgpack").unlink()
        trainer = Trainer(model=run.model, n_epochs=0, device="cpu")
        with pytest.warns(UserWarning, match="warm_start_opt"):
            trainer.train(*run.loaders(False, False), build_optimizer(_opt_cfg(policy)),
                          warm_start_from=src, warm_start_name="model", warm_start_opt=True)
        assert int(trainer.optimizer.count) == 0


def test_resumed_run_keeps_its_stored_best(tmp_path):
    run = Run(seed=5)
    save = dict(save_every=1, save_dir=tmp_path, save_best=f"{RES}_l2")
    run.port(2, **save)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["epoch"] == 1 and manifest["best_key"] == f"{RES}_l2"
    assert 0 <= manifest["best_epoch"] <= 1 and np.isfinite(manifest["best_metric"])
    # the interrupted run had found an unbeatable best
    manifest["best_metric"] = 1e-12
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    best_bytes = (tmp_path / "best_model.msgpack").read_bytes()
    trainer, _ = run.port(4, fresh=False, resume_from_dir=tmp_path, **save)
    assert trainer.start_epoch == 2
    assert (tmp_path / "best_model.msgpack").read_bytes() == best_bytes
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["best_metric"] == 1e-12 and manifest["epoch"] == 3
    # a fresh run into the reused directory starts a new manifest
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run.port(1, save_every=1, save_dir=tmp_path)
    assert json.loads((tmp_path / "manifest.json").read_text()) == {"epoch": 0}


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_a_staged_trainer_is_freed_by_reference_counting(mixed_precision):
    """The staged step's closures do not hold the Trainer that holds them, so
    dropping the last reference frees the Trainer, its model's state and (on
    the card) its CUDA graph at once, without waiting for the cyclic
    garbage collector."""
    import gc
    import weakref

    run = Run()
    warm = Trainer(model=run.model, n_epochs=1, device="cpu")  # first-use warnings
    warm.train(*run.loaders(False, False), build_optimizer(_opt_cfg("full"), 4),
               device_dataset=True)
    del warm
    gc.collect()
    gc.disable()
    try:
        trainer = Trainer(model=run.model, n_epochs=1, device="cpu",
                          mixed_precision=mixed_precision)
        trainer.train(*run.loaders(False, False), build_optimizer(_opt_cfg("full"), 4),
                      device_dataset=True)
        assert trainer.staged_step is not None
        ref = weakref.ref(trainer)
        del trainer
        assert ref() is None
    finally:
        gc.enable()
