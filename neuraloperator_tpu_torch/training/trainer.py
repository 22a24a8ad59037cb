"""Trainer: the epoch loop, train and eval steps, checkpoints and resume (port
of ``neuraloperator_tpu/training/trainer.py``).

Dict batches ``{'x', 'y', ...}`` flow through ``data_processor.preprocess``
-> model -> f32 output -> ``postprocess`` -> loss, as in the JAX
``Trainer``. A train step is forward, ``backward`` (the spectral layers'
backward runs the contraction kernels K2 and K3 on the card) and one update
of the bound optimizer, scaled by the per-epoch scheduler's factor.
Evaluation gives the ``{loader}_{loss}`` metric dict.

Two ways through an epoch, as in the JAX package: the loader loop (one
eager step per batch), and ``device_dataset``, which stages the training
set on the device once and gathers each shuffled batch there by index; on
the card that step is one CUDA graph, replayed (``staged_step.py``).
Checkpoints are the JAX package's files (``training_state.py``): a run of
either package resumes, or warm-starts from, the other's.

``mixed_precision=True`` is the JAX ``Trainer``'s ``_half_policy``: the
train and eval forwards (and the backward) run on bf16 copies of the f32
parameters and bf16 float inputs (:func:`half_precision_forward`), the loss
is taken on the output in f32, and the gradients land on the f32 master
parameters through the casts. Not ``torch.autocast``: its op lists keep
adds, GELU and reductions in f32, which the JAX package computes in bf16.

``train(rollout_steps=K)`` trains on trajectory targets ``y`` of shape
(b, K', c, spatial...), K' >= K: the model is unrolled K steps, each step's
output fed back through ``data_processor.feedback`` (detached between steps
with ``pushforward=True``, full backpropagation through time without), and
the loss is the mean of the K steps' losses. ``evaluate(mode=
"autoregression")`` rolls the model out over such a trajectory.
``stochastic_rounding=True`` trains bf16 master parameters, each update
rounded stochastically from f32 with noise drawn from the Trainer's
seeded ``sr_generator``.

With a ``mesh`` (``parallel.mesh.init``; or the current one with
``use_distributed=True``) each process is one rank of a ('data', 'model')
layout. Every rank reads the same global batches and keeps its data
rank's slice (``shard_batch``); the model's state is broadcast from rank 0
when training starts; after each backward the gradients are summed over
the data ranks for a loss with ``reduction="sum"`` and averaged for
``"mean"`` (the loss of the JAX package's step is over the global batch),
and so are the step's loss and each evaluation loss. A regularizer's
penalty and its gradient are added after those reductions, once (on the
whole parameters: a model slice is gathered for it). At model size > 1
each rank holds its model rank's slice of the spectral weights the JAX
package shards (``shard_params``, before the optimizer is bound, so the
optimizer's state is cut too): each rank holds its slice's whole
gradient, and nothing is reduced over the model group; a patching
processor that scatters its patches over the model ranks takes the model
group instead, every gradient reduced over it, and the weights whole.
``zero_sharding`` cuts the optimizer state over the data ranks
(``parallel.zero.bind_zero``: ``ZeroAdamW`` for AdamW, a Tensor-GaLore
with its ``zero_group``, bound in place of the replicated optimizer).
Saves gather the slices to the whole tree, which rank 0 alone writes
(every rank joins the gathers), and loads cut it again; rank 0 alone
prints. ``device_dataset`` is refused with a mesh, as in JAX.
"""

import json
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._common import resolve_device
from ..data.transforms import DefaultDataProcessor
from ..losses import LpLoss
from ..models import base_model  # a module: base_model imports this package too
from ..parallel import comm
from ..parallel import mesh as mesh_lib
from .staged_step import StagedStep
from .training_state import load_training_state, read_manifest, save_training_state


def _to_half(t):
    """A f32 tensor in bf16; anything else (another dtype, a mode count) as it is."""
    return t.to(torch.bfloat16) if isinstance(t, torch.Tensor) and t.dtype == torch.float32 \
        else t


def _half_params(model: torch.nn.Module) -> dict:
    """The model's parameters under the half policy (differentiable casts)."""
    return {name: _to_half(p) for name, p in model.named_parameters()}


def half_precision_forward(model: torch.nn.Module, kwargs: dict) -> torch.Tensor:
    """``model(**kwargs)`` under the JAX ``Trainer._half_policy``.

    Every f32 parameter and every f32 input is cast to bf16 (differentiably:
    the gradient reaches the f32 parameter in f32); a parameter stored in
    another dtype (the bf16 spectral weights of ``weight_dtype="bfloat16"``)
    is used as it is and gets a gradient in its own dtype.
    """
    return torch.func.functional_call(
        model, _half_params(model), kwargs={k: _to_half(v) for k, v in kwargs.items()})


def _output(model: torch.nn.Module, kwargs: dict, mixed_precision: bool) -> torch.Tensor:
    """The model's output in f32, under the half policy when ``mixed_precision``.

    A function, not a method: the step closures that call it must not hold
    the Trainer, which holds them (through ``staged_step``), or the Trainer,
    its model and its CUDA graph would outlive the last reference to it
    until the cyclic garbage collector ran.
    """
    if mixed_precision:
        return half_precision_forward(model, kwargs).float()
    return model(**kwargs).float()


def refuse_batch_stats(model: torch.nn.Module) -> None:
    """Raise for a model that keeps BatchNorm running statistics.

    The JAX Trainer applies its model to ``{"params": ...}`` alone and never
    marks ``batch_stats`` mutable, so flax raises ``ScopeCollectionNotFound``
    at a ``norm="batch_norm"`` FNO's first train or eval step; the port's
    Trainer refuses such a model in the same places.
    """
    from ..layers.normalization_layers import BatchNorm

    names = [name for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    if names:
        raise ValueError(
            f"the model keeps BatchNorm running statistics ({names[0]}, ...: flax's "
            "'batch_stats' collection), which the Trainer does not carry: the JAX Trainer "
            "applies the model to its parameters alone, where flax raises "
            "ScopeCollectionNotFound"
        )


def _reduce_step(plan: dict, loss: torch.Tensor) -> torch.Tensor:
    """The gradients and the loss of a distributed step reduced over the
    ranks by ``Trainer._sync_plan``'s plan; returns the step's loss."""
    for group, reduction in plan["grads"]:
        comm.reduce_gradients(plan["params"], group, reduction)
    for group, reduction in plan["loss"]:
        loss = comm.reduce_value(loss, group, reduction)
    return loss


# the seed of stochastic rounding's noise (the JAX Trainer's base key)
SR_SEED = 0x5757


class Trainer:
    """Trains ``model`` (an ``nn.Module``) on ``device``, ``"cuda"`` by default."""

    def __init__(
        self,
        *,
        model: torch.nn.Module,
        n_epochs: int,
        wandb_log: bool = False,
        device="cuda",
        mesh=None,
        mixed_precision: bool = False,
        data_processor=None,
        eval_interval: int = 1,
        log_output: bool = False,
        use_distributed: bool = False,
        zero_sharding: bool = False,
        stochastic_rounding: bool = False,
        verbose: bool = False,
    ):
        # wandb logging, off when the package is missing (as in JAX): after
        # each evaluation the metrics and train_err, with log_output the
        # first evaluation prediction as a wandb.Image
        self._wandb = None
        if wandb_log:
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                wandb_log = False
        self.wandb_log = wandb_log
        self.log_output = log_output
        self.device = resolve_device(device)
        self.mesh = mesh or (mesh_lib.get_mesh() if use_distributed else None)
        self.zero_sharding = zero_sharding
        # bf16 master parameters, updated by stochastic rounding; the noise
        # comes from one generator on the device, seeded by train() from
        # SR_SEED and the run's first epoch and advanced every step (the JAX
        # Trainer folds the epoch and the step into a fixed key)
        self.stochastic_rounding = stochastic_rounding
        self.sr_generator = None
        if stochastic_rounding:
            self.sr_generator = torch.Generator(device=self.device).manual_seed(SR_SEED)
        self.model = model.to(self.device)
        self.n_epochs = n_epochs
        self.mixed_precision = mixed_precision
        self.data_processor = data_processor
        self.eval_interval = eval_interval
        self.verbose = verbose
        self.optimizer = None
        self.start_epoch = 0
        self.staged_step: Optional[StagedStep] = None
        # keyword arguments that every train step adds to its model call, read
        # at each call: a subclass changes them between epochs (the
        # incremental FNO's n_modes). A dict, not a method, so that the step
        # closures do not hold the Trainer (see _output).
        self.train_forward_kwargs: dict = {}

    # ------------------------------------------------------------------ #
    def _put(self, batch: dict) -> dict:
        if self.mesh is not None:
            return mesh_lib.shard_batch(batch, self.mesh)
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the files and prints (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _sync_plan(self, training_loss) -> Optional[dict]:
        """The reductions of a distributed step, or None without a mesh:
        ``grads`` ((group, reduction) for every parameter) and ``loss``."""
        mesh = self.mesh
        if mesh is None:
            return None
        reduction = getattr(training_loss, "reduction", None)
        if reduction not in ("sum", "mean"):
            raise ValueError("a distributed step needs a loss with reduction 'sum' or 'mean' "
                             f"(the reduction of its value over the ranks), got {reduction!r}")
        patcher = getattr(self.data_processor, "patcher", None)
        split = bool(getattr(patcher, "splits_over_model", False))
        grads = [(mesh.data_group, reduction)]
        loss = [(mesh.data_group, reduction)]
        if split:
            # stitched outputs give every model rank the whole loss, whose
            # gradient each rank holds for its own patches alone
            stitched = patcher.stitching
            grads.append((mesh.model_group, "sum" if stitched else reduction))
            if not stitched:
                loss.append((mesh.model_group, reduction))
        return {"grads": grads, "loss": loss, "params": list(self.model.parameters())}

    def _build_train_step(self, training_loss, regularizer=None, rollout_steps: int = 1,
                          pushforward: bool = True) -> Callable:
        data_processor = self.data_processor
        model = self.model
        optimizer = self.optimizer
        mixed = self.mixed_precision
        generator = self.sr_generator
        forward_kwargs = self.train_forward_kwargs
        plan = self._sync_plan(training_loss)
        # A distributed step adds the penalty and its gradient after the
        # reductions, once: inside them it would be summed over the ranks.
        # It sees the whole parameters: a model slice is gathered (its
        # gradient then reaches this rank's slice alone)
        inline_penalty = regularizer is not None and plan is None
        layout = mesh_lib.model_parallel_layout(model)

        def penalty():
            # a penalty on the parameters, given as the flat
            # {flax-style dotted name: tensor} dict
            params = dict(model.named_parameters())
            if layout is not None:
                group, dims = layout
                params = {n: comm.gather_from_model_parallel_region(p, dims[n], group)
                          if n in dims else p for n, p in params.items()}
            return regularizer.loss(params) if hasattr(regularizer, "loss") \
                else regularizer(params)

        def rollout_loss(sample, kwargs):
            # the JAX Trainer's rollout branch: the half policy casts the
            # parameters and the first inputs once; a fed-back prediction
            # enters the next step in the dtype feedback gives it
            x = kwargs.pop("x")
            if mixed:
                params = _half_params(model)
                kwargs = {k: _to_half(v) for k, v in kwargs.items()}
                x = _to_half(x)

                def forward(x):
                    return torch.func.functional_call(model, params, kwargs={"x": x, **kwargs})
            else:
                def forward(x):
                    return model(x, **kwargs)
            feedback = getattr(data_processor, "feedback", None)
            losses = []
            for j in range(rollout_steps):
                out = forward(x)
                losses.append(training_loss(out.float(), sample["y"][:, j]))
                if j < rollout_steps - 1:
                    nxt = out if feedback is None else feedback(out)
                    x = nxt.detach() if pushforward else nxt
            return sum(losses) / rollout_steps

        def loss_fn(batch):
            sample = dict(batch)
            if data_processor is not None:
                sample = data_processor.preprocess(sample, train=True)
            # keys with the reserved "_loss_" prefix are loss auxiliaries,
            # not model arguments
            kwargs = {
                k: v for k, v in sample.items() if k != "y" and not k.startswith("_loss_")
            }
            kwargs.update(forward_kwargs)
            if rollout_steps > 1:
                loss = rollout_loss(sample, kwargs)
                return loss + penalty() if inline_penalty else loss
            out = _output(model, kwargs, mixed)
            if data_processor is not None:
                out, sample = data_processor.postprocess(out, sample, train=True)
            if "_loss_ynorm_sq" in sample:
                loss = training_loss(out, sample["y"], ynorm_sq=sample["_loss_ynorm_sq"])
            else:
                loss = training_loss(out, sample["y"])
            return loss + penalty() if inline_penalty else loss

        # an optimizer under reduce_on_plateau takes the step's loss (optax's value=)
        needs_value = getattr(optimizer, "needs_value", False)

        def step(batch, lr_scale) -> torch.Tensor:
            # nothing here reads the device: the staged path captures it
            model.train()
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(batch)
            loss.backward()
            if plan is not None:
                loss = _reduce_step(plan, loss.detach())
                if regularizer is not None:
                    value = penalty()
                    value.backward()
                    loss = loss + value.detach()
            extra = {"value": loss.detach()} if needs_value else {}
            if generator is not None:
                extra["generator"] = generator
            optimizer.step(lr_scale=lr_scale, **extra)
            return loss.detach()

        return step

    def _build_eval_step(self, eval_losses) -> Callable:
        data_processor = self.data_processor
        model = self.model
        mixed = self.mixed_precision
        group = None if self.mesh is None else self.mesh.data_group

        @torch.no_grad()
        def step(batch) -> Dict[str, torch.Tensor]:
            model.eval()
            sample = dict(batch)
            if data_processor is not None:
                sample = data_processor.preprocess(sample, train=False)
            kwargs = {k: v for k, v in sample.items() if k != "y"}
            out = _output(model, kwargs, mixed)
            if data_processor is not None:
                out, sample = data_processor.postprocess(out, sample, train=False)
            values = {name: loss(out, sample["y"]) for name, loss in eval_losses.items()}
            if group is not None:
                values = {name: comm.reduce_value(v, group, getattr(eval_losses[name],
                                                                     "reduction", "sum"))
                          for name, v in values.items()}
            return values

        return step

    def _stage(self, train_loader, batch_size: int, train_step, training_loss,
               rollout_steps: int) -> StagedStep:
        """The loader's batches, in its order, as one set on the device."""
        stacked: Dict[str, list] = {}
        for batch in train_loader:
            for k, v in batch.items():
                stacked.setdefault(k, []).append(np.asarray(v))
        data = {k: torch.from_numpy(np.concatenate(v)).to(self.device)
                for k, v in stacked.items()}
        if len(data["x"]) < batch_size:
            raise ValueError(f"{len(data['x'])} staged samples hold no batch of {batch_size}")
        # a loss whose relative denominator depends on the target alone
        # (H1Loss.ynorm_sq) gets it once over the staged set: each step then
        # runs one finite-difference pass, on the difference (not for a
        # rollout, whose targets are trajectories)
        dp = self.data_processor
        if rollout_steps == 1 and hasattr(training_loss, "ynorm_sq") and (
                dp is None or isinstance(dp, DefaultDataProcessor)):
            with torch.no_grad():
                sample = dp.preprocess(dict(data), train=True) if dp is not None else data
                data["_loss_ynorm_sq"] = training_loss.ynorm_sq(sample["y"])
        generators = () if self.sr_generator is None else (self.sr_generator,)
        return StagedStep(train_step, data, batch_size, generators=generators)

    def _staged_epoch(self, staged: StagedStep, perm: np.ndarray, lr_scale: float,
                      epoch_scan_chunk: Optional[int]) -> float:
        """One epoch over the staged set in the order ``perm``; its ``train_err``.

        As the JAX epoch program: the trailing partial batch is dropped; with
        ``epoch_scan_chunk`` below the epoch's batch count, the epoch runs
        as equal chunks of ``nb_total // k_chunks`` steps (the last
        ``nb_total % k_chunks`` batches dropped) and ``train_err`` is the
        mean of the chunks' mean losses. The host reads the device once.
        """
        batch_size = staged.index.shape[0]
        nb_total = len(perm) // batch_size
        k_chunks = 1
        if epoch_scan_chunk is not None and nb_total > epoch_scan_chunk:
            k_chunks = -(-nb_total // epoch_scan_chunk)
        steps = nb_total // k_chunks
        order = torch.from_numpy(
            perm[:k_chunks * steps * batch_size].reshape(k_chunks, steps, batch_size)
        ).to(self.device)
        staged.lr_scale.fill_(lr_scale)
        chunk_sums = torch.zeros(k_chunks, dtype=torch.float64, device=self.device)
        for c in range(k_chunks):
            staged.loss_sum.zero_()
            for i in range(steps):
                staged(order[c, i])
            chunk_sums[c] = staged.loss_sum
        return float((chunk_sums / steps).mean())

    # ------------------------------------------------------------------ #
    def train(
        self,
        train_loader,
        test_loaders: Dict,
        optimizer,
        scheduler=None,
        regularizer=None,
        training_loss=None,
        eval_losses=None,
        save_every: Optional[int] = None,
        save_best: Optional[str] = None,
        save_dir="./ckpt",
        resume_from_dir=None,
        warm_start_from=None,
        warm_start_name: str = "best_model",
        warm_start_opt: bool = False,
        rollout_steps: int = 1,
        pushforward: bool = True,
        device_dataset: bool = False,
        epoch_scan_chunk: Optional[int] = None,
        shuffle_seed: int = 0,
    ) -> Dict[str, float]:
        """Train from ``start_epoch`` to ``n_epochs`` and return the last metrics.

        ``optimizer`` is what ``training.adamw`` or ``build_optimizer``
        returns; it is bound to the model's named parameters here, so its
        state starts fresh, as the JAX ``Trainer`` initialises its optax
        state. ``scheduler`` follows the per-epoch protocol: after every
        epoch the Trainer calls ``scheduler.step()`` (``step(train_err)``
        when it declares ``needs_metric``) and multiplies the updates by
        ``scheduler.factor``. The returned dict holds ``train_err`` and
        ``epoch_time`` of the last epoch and the last evaluation's
        ``{loader}_{loss}`` entries.

        As in the JAX ``Trainer``:

        * ``warm_start_from``: load the weights of ``{warm_start_name}.msgpack``
          there, keeping the fresh optimizer state and epoch (with
          ``warm_start_opt``, also the donor's ``optimizer.msgpack``; a
          donor without one, or of another optimizer, warns and keeps the
          fresh state). Ignored when resuming.
        * ``resume_from_dir``: restore ``model.msgpack``, the optimizer state
          and the epoch there, and go on at ``epoch + 1``; with
          ``save_best``, the manifest's best metric for the same key is the
          one to beat. A fresh run that saves into ``save_dir`` deletes a
          stale ``manifest.json`` there first.
        * ``save_best``: after every evaluation that lowers that metric,
          save ``best_model.msgpack`` (no epoch, so the resume epoch stays
          the periodic save's); ``save_every``: save ``model.msgpack`` and
          ``optimizer.msgpack`` every that many epochs, and once more after
          the last epoch. Either also writes the architecture sidecars and
          ``data_processor.json``.
        * ``device_dataset``: stage the loader's batches once on the device
          and run each epoch over them in the order of
          ``np.random.default_rng(shuffle_seed).permutation``, on the card
          as a replayed CUDA graph; ``epoch_scan_chunk`` splits an epoch
          into equal chunks (``_staged_epoch``).
        * ``rollout_steps > 1``: each batch's ``y`` is a trajectory
          (b, K, c, spatial...) with K >= ``rollout_steps``; the model is
          unrolled, feeding its predictions back, with the gradient stopped
          between steps when ``pushforward`` (one step's backward cost) or
          taken through the whole chain when not. On the staged path the
          trajectories are staged whole.
        * ``stochastic_rounding`` (the Trainer's): every f32 parameter is
          cast to bf16 before the optimizer is bound (whose state is still
          f32), and each step rounds its updates in stochastically.
        """
        if not hasattr(optimizer, "bind"):
            raise TypeError(
                "optimizer must be what training.adamw or build_optimizer returns, "
                f"got {type(optimizer).__name__}"
            )
        refuse_batch_stats(self.model)
        if training_loss is None:
            training_loss = LpLoss(d=2)
        if eval_losses is None:
            eval_losses = {"l2": LpLoss(d=2)}

        # The JAX Trainer draws a first batch before its loop (to initialise
        # its parameters), which advances a shuffling loader by one epoch;
        # drawing it here too gives both trainers the same batches for one seed.
        first_batch = next(iter(train_loader))
        # a batch in the_well's layout is formatted by TheWellDataProcessor
        if "output_fields" not in first_batch and ("x" not in first_batch
                                                   or "y" not in first_batch):
            raise ValueError(f"batches must hold 'x' and 'y', got keys {sorted(first_batch)}")
        if rollout_steps > 1:
            y0 = np.asarray(first_batch["y"])
            if y0.ndim < 3 or y0.shape[1] < rollout_steps:
                raise ValueError(
                    f"rollout_steps={rollout_steps} needs trajectory targets "
                    f"(b, K>={rollout_steps}, c, spatial...); got {y0.shape}"
                )
        if self.mesh is not None:
            if device_dataset:
                raise ValueError("device_dataset is a single-device path; use the loader loop "
                                 "with a mesh")
            mesh_lib.replicate(self.model, self.mesh)
            patcher = getattr(self.data_processor, "patcher", None)
            if not getattr(patcher, "splits_over_model", False):
                mesh_lib.shard_params(self.model, self.mesh)
        if self.stochastic_rounding:
            # bf16 MASTER parameters: the update phase carries no f32 copy
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(torch.bfloat16)
        layout = mesh_lib.model_parallel_layout(self.model)
        if self.mesh is not None and self.zero_sharding:
            from ..parallel.zero import bind_zero

            self.optimizer = bind_zero(optimizer, self.model.named_parameters(), self.mesh,
                                       model_parallel=layout)
        elif layout is not None:
            self.optimizer = optimizer.bind(self.model.named_parameters(),
                                            model_parallel=layout)
        else:
            self.optimizer = optimizer.bind(self.model.named_parameters())
        if warm_start_from is not None and resume_from_dir is None:
            self._warm_start(warm_start_from, warm_start_name, warm_start_opt)
        if resume_from_dir is not None and Path(resume_from_dir).exists():
            self._resume(resume_from_dir)

        if self.sr_generator is not None:
            # a resumed run draws other noise than the run it resumes
            self.sr_generator.manual_seed(SR_SEED + self.start_epoch)
        train_step = self._build_train_step(training_loss, regularizer, rollout_steps,
                                            pushforward)
        eval_step = self._build_eval_step(eval_losses)
        shuffle_rng = np.random.default_rng(shuffle_seed)
        self.staged_step = None
        if device_dataset:
            self.staged_step = self._stage(train_loader, len(first_batch["x"]), train_step,
                                           training_loss, rollout_steps)
        saving = save_every is not None or save_best is not None
        best_metric = self._prepare_save_dir(save_dir, saving, save_best, resume_from_dir)

        all_metrics: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.n_epochs):
            t0 = time.perf_counter()
            if self.data_processor is not None and hasattr(self.data_processor, "step"):
                self.data_processor.step(epoch)
            lr_scale = float(np.float32(getattr(scheduler, "factor", 1.0)))
            if self.staged_step is not None:
                perm = shuffle_rng.permutation(len(self.staged_step.data["x"]))
                train_err = self._staged_epoch(self.staged_step, perm, lr_scale,
                                               epoch_scan_chunk)
            else:
                # float64 on the device: the JAX Trainer sums Python floats
                loss_sum = torch.zeros((), dtype=torch.float64, device=self.device)
                n_batches = 0
                for batch in train_loader:
                    loss_sum += train_step(self._put(batch), lr_scale)
                    n_batches += 1
                train_err = float(loss_sum) / max(n_batches, 1)
            if scheduler is not None:
                if getattr(scheduler, "needs_metric", False):
                    scheduler.step(train_err)
                else:
                    scheduler.step()
            epoch_time = time.perf_counter() - t0
            all_metrics["train_err"] = train_err
            all_metrics["epoch_time"] = epoch_time
            self._end_epoch(epoch, train_err)

            if epoch % self.eval_interval == 0 or epoch == self.n_epochs - 1:
                eval_metrics = self.evaluate_all(eval_step, test_loaders)
                all_metrics.update(eval_metrics)
                if self.wandb_log:
                    # every rank renders (a sharded forward is collective), rank 0 logs
                    img = self._render_eval_output(test_loaders) if self.log_output else None
                    if self.is_writer:
                        payload = {**eval_metrics, "train_err": train_err}
                        if img is not None:
                            payload["eval_output"] = img
                        self._wandb.log(payload, step=epoch)
                if self.verbose and self.is_writer:
                    msg = ", ".join(f"{k}={v:.5f}" for k, v in eval_metrics.items())
                    print(f"[{epoch}] time={epoch_time:.2f}s train={train_err:.5f} {msg}")
                metric = eval_metrics.get(save_best)
                if metric is not None and metric < best_metric:
                    best_metric = metric
                    # epoch=None: the best save must not move the manifest's
                    # resume epoch past the periodic save it rides with;
                    # every rank joins the gathers, rank 0 writes
                    state = mesh_lib.gather_state_dict(self.model)
                    if self.is_writer:
                        save_training_state(
                            save_dir, "best_model", state, epoch=None,
                            extra_manifest={"best_metric": float(metric), "best_epoch": epoch,
                                            "best_key": save_best},
                        )
            if save_every is not None and epoch % save_every == 0:
                self._save_state(save_dir, epoch)
        if saving:
            self._save_state(save_dir, self.n_epochs - 1)
        return all_metrics

    @torch.no_grad()
    def _render_eval_output(self, test_loaders: Dict):
        """The first prediction of the first evaluation batch as a
        ``wandb.Image``: its first channel (first slice of a field of more
        than two dims), scaled to [0, 1]; None when it cannot be made
        (logging never stops training)."""
        if self._wandb is None or not test_loaders:
            return None
        try:
            loader = next(iter(test_loaders.values()))
            sample = self._put(dict(next(iter(loader))))
            dp = self.data_processor
            if dp is not None:
                sample = dp.preprocess(sample, train=False)
            self.model.eval()
            out = self.model(**{k: v for k, v in sample.items() if k != "y"}).float()
            if dp is not None:
                out, _ = dp.postprocess(out, sample, train=False)
            arr = out[0].cpu().numpy()
            while arr.ndim > 2:
                arr = arr[0]
            lo, hi = float(arr.min()), float(arr.max())
            return self._wandb.Image((arr - lo) / (hi - lo + 1e-12))
        except Exception:
            return None

    def _save_state(self, save_dir, epoch: int) -> None:
        """``model.msgpack`` and ``optimizer.msgpack``; every rank gathers the
        model slices and a cut state, rank 0 writes."""
        opt_state = self.optimizer.state_dict()
        state = mesh_lib.gather_state_dict(self.model)
        if self.is_writer:
            save_training_state(save_dir, "model", state, opt_state, epoch=epoch)

    def _end_epoch(self, epoch: int, train_err: float) -> None:
        """Called after each epoch's scheduler step, before its evaluation."""

    def _warm_start(self, src, name: str, with_optimizer: bool) -> None:
        """Weights (and, asked, the optimizer state) of another run; the
        epoch and the schedule's position stay fresh."""
        state, _, src_epoch = load_training_state(src, name, self.model, device=self.device)
        self.model.load_state_dict(state)
        opt_state = None
        if with_optimizer:
            try:
                _, opt_state, _ = load_training_state(
                    src, name, self.model, self.optimizer.state_dict(), device=self.device)
                if opt_state is None:
                    warnings.warn(f"warm_start_opt=True but no optimizer.msgpack under {src}; "
                                  "continuing with a fresh optimizer state")
                else:
                    self.optimizer.load_state_dict(opt_state)
            except ValueError as e:  # the donor used another optimizer
                opt_state = None
                warnings.warn(f"warm_start_opt=True but the donor optimizer state under {src} "
                              f"does not match this run's optimizer ({e}); continuing with a "
                              "fresh state")
        if self.verbose and self.is_writer:
            print(f"warm-starting params from {src}/{name} (source epoch {src_epoch}, "
                  f"optimizer state {'loaded' if opt_state is not None else 'fresh'})")

    def _resume(self, src) -> None:
        state, opt_state, epoch = load_training_state(
            src, "model", self.model, self.optimizer.state_dict(), device=self.device)
        self.model.load_state_dict(state)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        if epoch is not None:
            self.start_epoch = epoch + 1
        if self.verbose and self.is_writer:
            print(f"resuming from {src} at epoch {self.start_epoch}")

    def _prepare_save_dir(self, save_dir, saving: bool, save_best, resume_from_dir) -> float:
        """The best metric to beat; writes the sidecars of a saving run."""
        best_metric = float("inf")
        if resume_from_dir is not None and save_best is not None:
            # a resumed run must not let its first (typically worse) eval
            # overwrite the stored best_model
            manifest = read_manifest(resume_from_dir, tolerate_damage=True) or {}
            if manifest.get("best_key") == save_best:
                best_metric = float(manifest.get("best_metric", float("inf")))
        elif resume_from_dir is None and save_dir is not None and saving and self.is_writer:
            # a fresh run into a reused save_dir: a stale manifest must not
            # carry its best_metric or epoch into this run's saves
            stale = Path(save_dir) / "manifest.json"
            if stale.exists():
                stale.unlink()
        if saving and self.is_writer:
            # architecture sidecars, so that the weights rebuild without the
            # training script (scripts/serve_model.py, models.from_checkpoint)
            try:
                base_model.save_arch_metadata(self.model, save_dir, "model")
                if save_best is not None:
                    base_model.save_arch_metadata(self.model, save_dir, "best_model")
            except ValueError:
                pass  # not a registered model: the weights are still saved
            # the fitted normalizers, which do not change while training
            if self.data_processor is not None and hasattr(self.data_processor, "state_dict"):
                try:
                    Path(save_dir).mkdir(parents=True, exist_ok=True)
                    (Path(save_dir) / "data_processor.json").write_text(
                        json.dumps(self.data_processor.state_dict()))
                except (TypeError, ValueError):
                    pass
        return best_metric

    # ------------------------------------------------------------------ #
    def evaluate_all(self, eval_step, test_loaders: Dict) -> Dict[str, float]:
        metrics = {}
        for loader_name, loader in test_loaders.items():
            metrics.update(self.evaluate(eval_step, loader, prefix=str(loader_name)))
        return metrics

    def evaluate(
        self,
        eval_step,
        loader,
        prefix: str,
        mode: str = "single_step",
        eval_losses=None,
        max_steps: Optional[int] = None,
    ) -> Dict[str, float]:
        """Mean over samples of each loss's per-batch sum (``"sum"`` reduction).

        ``mode="autoregression"`` rolls the model out over each batch's
        trajectory ``y`` (b, T, c, spatial...) from ``x``, feeding each
        prediction back as the next input, and scores every step with
        ``eval_losses``: a batch's value is its per-step sums summed over
        the steps and divided by T (``max_steps`` caps T; by default the
        data processor's ``n_steps_rollout``, if it has one).
        """
        if mode not in ("single_step", "autoregression"):
            raise ValueError(f"unknown eval mode {mode!r}")
        refuse_batch_stats(self.model)
        dp = self.data_processor
        totals: Dict[str, torch.Tensor] = {}  # float64, as loss_sum in train
        n_samples = 0
        for batch in loader:
            if (mode == "autoregression" and dp is not None
                    and hasattr(dp, "format_rollout_batch") and "output_fields" in batch):
                # a trajectory batch in the_well's layout
                batch = dp.format_rollout_batch(self._put(dict(batch)))
            bsz = getattr(batch, "global_batch_size", 0) or (
                len(batch["x"]) if "x" in batch else len(next(iter(batch.values()))))
            if mode == "single_step":
                vals = eval_step(self._put(batch))
            else:
                vals = self._eval_autoregressive(self._put(batch), eval_losses, max_steps)
                if self.mesh is not None:
                    vals = {k: comm.reduce_value(v, self.mesh.data_group,
                                                 getattr(eval_losses[k], "reduction", "sum"))
                            for k, v in vals.items()}
            for k, v in vals.items():
                totals[k] = totals[k] + v if k in totals else v.double()
            n_samples += bsz
        return {f"{prefix}_{k}": float(v) / max(n_samples, 1) for k, v in totals.items()}

    @torch.no_grad()
    def _eval_autoregressive(self, batch, eval_losses, max_steps) -> Dict[str, torch.Tensor]:
        """One batch's rollout: ``{loss: sum over steps of the step's loss / T}``
        (float64; the sum over steps in f32, as the JAX scan's)."""
        dp = self.data_processor
        if max_steps is None:
            # a the_well-style processor can carry the rollout horizon
            max_steps = getattr(dp, "n_steps_rollout", None)
        y = batch["y"]
        T = y.shape[1] if max_steps is None else min(max_steps, y.shape[1])
        names = tuple(sorted(eval_losses))
        self.model.eval()
        x = batch["x"]
        per_step = []
        for t in range(T):
            sample = {"x": x}
            if dp is not None:
                sample = dp.preprocess(sample, train=False)
            out = self.model(sample["x"])
            if dp is not None:
                out, _ = dp.postprocess(out, sample, train=False)
            per_step.append(torch.stack([
                torch.as_tensor(eval_losses[k](out, y[:, t]), dtype=torch.float32)
                for k in names]))
            # a the_well-style processor shifts its input window instead
            x = dp.ar_feedback(x, out) if hasattr(dp, "ar_feedback") else out
        self._last_rollout_T = T  # introspection for tests and metrics
        sums = (torch.stack(per_step).sum(dim=0) if per_step
                else torch.zeros(len(names), device=self.device))
        return {k: sums[i].double() / max(T, 1) for i, k in enumerate(names)}
