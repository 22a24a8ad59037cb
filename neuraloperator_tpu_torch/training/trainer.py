"""Trainer: the epoch loop over a loader, train and eval steps (port of
``neuraloperator_tpu/training/trainer.py``).

Dict batches ``{'x', 'y', ...}`` flow through ``data_processor.preprocess``
-> model -> f32 output -> ``postprocess`` -> loss, as in the JAX
``Trainer``. Each train step is eager PyTorch: forward, ``backward`` (the
spectral layers' backward runs the contraction kernels K2 and K3 on the
card) and one update of the bound optimizer, scaled by the per-epoch
scheduler's factor. Evaluation gives the ``{loader}_{loss}`` metric dict.

Ported: the single-device loader loop. Options of the JAX ``Trainer`` that
are not ported raise ``NotImplementedError`` naming their ROADMAP item.
"""

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._common import not_ported, resolve_device
from ..losses import LpLoss


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
        del log_output  # read only by wandb logging in the JAX Trainer
        if wandb_log:
            raise not_ported("Trainer wandb_log", "the rest of losses, training and data")
        if mesh is not None or use_distributed or zero_sharding:
            raise not_ported("Trainer mesh/use_distributed/zero_sharding", "distribution")
        if mixed_precision:
            raise not_ported("Trainer mixed_precision", "mixed/half precision")
        if stochastic_rounding:
            raise not_ported("Trainer stochastic_rounding", "factored8/EMA/SR")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.n_epochs = n_epochs
        self.data_processor = data_processor
        self.eval_interval = eval_interval
        self.verbose = verbose
        self.optimizer = None

    # ------------------------------------------------------------------ #
    def _put(self, batch: dict) -> dict:
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    def _build_train_step(self, training_loss, regularizer=None) -> Callable:
        data_processor = self.data_processor
        model = self.model
        optimizer = self.optimizer

        def loss_fn(batch):
            sample = dict(batch)
            if data_processor is not None:
                sample = data_processor.preprocess(sample, train=True)
            # keys with the reserved "_loss_" prefix are loss auxiliaries,
            # not model arguments
            kwargs = {
                k: v for k, v in sample.items() if k != "y" and not k.startswith("_loss_")
            }
            out = model(**kwargs).float()
            if data_processor is not None:
                out, sample = data_processor.postprocess(out, sample, train=True)
            if "_loss_ynorm_sq" in sample:
                loss = training_loss(out, sample["y"], ynorm_sq=sample["_loss_ynorm_sq"])
            else:
                loss = training_loss(out, sample["y"])
            if regularizer is not None:
                # a penalty on the parameters, given as the flat
                # {flax-style dotted name: tensor} dict
                params = dict(model.named_parameters())
                loss = loss + (
                    regularizer.loss(params) if hasattr(regularizer, "loss")
                    else regularizer(params)
                )
            return loss

        def step(batch, lr_scale: float) -> torch.Tensor:
            model.train()
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(batch)
            loss.backward()
            optimizer.step(lr_scale=lr_scale)
            return loss.detach()

        return step

    def _build_eval_step(self, eval_losses) -> Callable:
        data_processor = self.data_processor
        model = self.model

        @torch.no_grad()
        def step(batch) -> Dict[str, torch.Tensor]:
            model.eval()
            sample = dict(batch)
            if data_processor is not None:
                sample = data_processor.preprocess(sample, train=False)
            kwargs = {k: v for k, v in sample.items() if k != "y"}
            out = model(**kwargs).float()
            if data_processor is not None:
                out, sample = data_processor.postprocess(out, sample, train=False)
            return {name: loss(out, sample["y"]) for name, loss in eval_losses.items()}

        return step

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
        """Train for ``n_epochs`` and return the last metrics.

        ``optimizer`` is what ``training.adamw`` or ``build_optimizer``
        returns; it is bound to the model's parameters here, so its state
        starts fresh, as the JAX ``Trainer`` initialises its optax state.
        ``scheduler`` follows the per-epoch protocol: after every epoch the
        Trainer calls ``scheduler.step()`` (``step(train_err)`` when it
        declares ``needs_metric``) and multiplies the updates by
        ``scheduler.factor``. The returned dict holds ``train_err`` and
        ``epoch_time`` of the last epoch and the last evaluation's
        ``{loader}_{loss}`` entries.
        """
        del save_dir, warm_start_name, pushforward, shuffle_seed  # no effect here
        if save_every is not None or save_best is not None:
            raise not_ported("Trainer.train save_every/save_best", "checkpoint save/resume")
        if resume_from_dir is not None or warm_start_from is not None or warm_start_opt:
            raise not_ported(
                "Trainer.train resume_from_dir/warm_start_from", "checkpoint save/resume"
            )
        if rollout_steps > 1:
            raise not_ported("Trainer.train rollout_steps > 1",
                             "the rest of losses, training and data")
        if device_dataset or epoch_scan_chunk is not None:
            raise not_ported("Trainer.train device_dataset/epoch_scan_chunk", "device_dataset")
        if not hasattr(optimizer, "bind"):
            raise TypeError(
                "optimizer must be what training.adamw or build_optimizer returns, "
                f"got {type(optimizer).__name__}"
            )
        if training_loss is None:
            training_loss = LpLoss(d=2)
        if eval_losses is None:
            eval_losses = {"l2": LpLoss(d=2)}

        # The JAX Trainer draws a first batch before its loop (to initialise
        # its parameters), which advances a shuffling loader by one epoch;
        # drawing it here too gives both trainers the same batches for one seed.
        first_batch = next(iter(train_loader))
        if "x" not in first_batch or "y" not in first_batch:
            raise ValueError(f"batches must hold 'x' and 'y', got keys {sorted(first_batch)}")
        self.optimizer = optimizer.bind(self.model.parameters())
        train_step = self._build_train_step(training_loss, regularizer)
        eval_step = self._build_eval_step(eval_losses)

        all_metrics: Dict[str, float] = {}
        for epoch in range(self.n_epochs):
            t0 = time.perf_counter()
            if self.data_processor is not None and hasattr(self.data_processor, "step"):
                self.data_processor.step(epoch)
            lr_scale = float(np.float32(getattr(scheduler, "factor", 1.0)))
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

            if epoch % self.eval_interval == 0 or epoch == self.n_epochs - 1:
                eval_metrics = self.evaluate_all(eval_step, test_loaders)
                all_metrics.update(eval_metrics)
                if self.verbose:
                    msg = ", ".join(f"{k}={v:.5f}" for k, v in eval_metrics.items())
                    print(f"[{epoch}] time={epoch_time:.2f}s train={train_err:.5f} {msg}")
        return all_metrics

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
        """Mean over samples of each loss's per-batch sum (``"sum"`` reduction)."""
        if mode == "autoregression":
            raise not_ported("Trainer.evaluate mode='autoregression'",
                             "the rest of losses, training and data")
        if mode != "single_step":
            raise ValueError(f"unknown eval mode {mode!r}")
        totals: Dict[str, torch.Tensor] = {}  # float64, as loss_sum in train
        n_samples = 0
        for batch in loader:
            bsz = len(batch["x"]) if "x" in batch else len(next(iter(batch.values())))
            for k, v in eval_step(self._put(batch)).items():
                totals[k] = totals[k] + v if k in totals else v.double()
            n_samples += bsz
        return {f"{prefix}_{k}": float(v) / max(n_samples, 1) for k, v in totals.items()}
