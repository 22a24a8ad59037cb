"""Incremental FNO trainer, iFNO (port of ``neuraloperator_tpu/training/incremental.py``).

The Fourier modes a layer uses grow during training: the weights are sized
by the model's ``max_n_modes`` and every train step calls the model with the
trainer's ``current_n_modes`` (the FNO's per-call ``n_modes``), which one of
two criteria raises by one after an epoch: the loss gap (the epoch's loss
moved by at most ``incremental_loss_eps``) or the explained variance of the
first spectral layer's accumulated weight gradient. Evaluation calls the
model with its own ``n_modes``, as the JAX trainer does.

The ``Trainer``'s loader loop runs the epochs (the JAX trainer retraces its
step once per mode count; here each call simply takes its count), so saving
and resuming work as there; the mode count is not saved, and a resumed run
starts again from ``starting_n_modes``. Unlike the JAX trainer's own loop,
that loop also calls a data processor's ``step(epoch)``.
"""

from typing import Optional

import numpy as np

from ..utils import compute_explained_variance
from .trainer import Trainer


class IncrementalFNOTrainer(Trainer):
    """A ``Trainer`` whose train steps use ``current_n_modes``, raised by the
    loss-gap (``incremental_loss_gap``) or the gradient
    (``incremental_grad``) criterion; exactly one must be on.
    ``modes_by_epoch`` records the modes each epoch trained with."""

    def __init__(
        self,
        *,
        model,
        n_epochs: int,
        incremental_grad: bool = False,
        incremental_loss_gap: bool = False,
        incremental_grad_eps: float = 0.001,
        incremental_buffer: int = 5,
        incremental_grad_max_iter: int = 10,
        incremental_loss_eps: float = 0.001,
        starting_n_modes=None,
        **kwargs,
    ):
        super().__init__(model=model, n_epochs=n_epochs, **kwargs)
        if not (incremental_grad or incremental_loss_gap):
            raise ValueError("IncrementalFNOTrainer expects one incremental algorithm enabled")
        if incremental_grad and incremental_loss_gap:
            raise ValueError("only one incremental algorithm may be enabled")
        self.incremental_loss_gap = incremental_loss_gap
        self.incremental_grad = incremental_grad
        self.incremental_grad_eps = incremental_grad_eps
        self.incremental_buffer = incremental_buffer
        self.incremental_grad_max_iter = incremental_grad_max_iter
        self.incremental_loss_eps = incremental_loss_eps
        self.loss_list = []
        self.max_modes = tuple(model.max_n_modes or model.n_modes)
        self.current_n_modes = (
            starting_n_modes if starting_n_modes is not None else model.n_modes)
        self.accumulated_grad = None
        self.grad_iter = 1
        self.modes_by_epoch = []

    @property
    def current_n_modes(self) -> tuple:
        return self.train_forward_kwargs["n_modes"]

    @current_n_modes.setter
    def current_n_modes(self, n_modes) -> None:
        self.train_forward_kwargs["n_modes"] = tuple(n_modes)

    def train(self, *args, device_dataset: bool = False, **kwargs):
        """``Trainer.train`` on the loader loop; the last metrics."""
        if device_dataset:
            raise ValueError("the incremental FNO trains on the loader loop: a staged step "
                             "(one CUDA graph on the card) keeps the mode count it was "
                             "captured with")
        return super().train(*args, **kwargs)

    def _end_epoch(self, epoch: int, train_err: float) -> None:
        self.modes_by_epoch.append(self.current_n_modes)
        self.incremental_update(train_err, self._first_conv_grad())
        if self.verbose:
            print(f"[{epoch}] modes={self.current_n_modes}")

    # ------------------------------------------------------------------ #
    def incremental_update(self, loss: Optional[float], grads=None) -> None:
        if self.incremental_loss_gap and loss is not None:
            self.loss_gap(loss)
        if self.incremental_grad and grads is not None:
            self.grad_explained(grads)

    def loss_gap(self, loss: float) -> None:
        """One more mode when the epoch's loss moved by at most ``incremental_loss_eps``."""
        self.loss_list.append(loss)
        modes = self.current_n_modes[0]
        if len(self.loss_list) > 1:
            if abs(self.loss_list[-1] - self.loss_list[-2]) <= self.incremental_loss_eps:
                if modes < self.max_modes[0]:
                    modes += 1
        self.current_n_modes = tuple([modes] * len(self.current_n_modes))

    def _first_conv_grad(self) -> Optional[np.ndarray]:
        """The last step's gradient of the first spectral conv's weight, as a
        complex numpy array: JAX's ``fno_blocks/conv_0/w_weight`` (or the
        first factor by name), the port's ``fno_blocks.conv_0.w_weight``."""
        prefix = "fno_blocks.conv_0."
        params = {n[len(prefix):]: p for n, p in self.model.named_parameters()
                  if n.startswith(prefix) and "." not in n[len(prefix):]}
        if not params:
            return None
        name = "w_weight" if "w_weight" in params else sorted(params)[0]
        grad = params[name].grad
        if grad is None:
            return None
        stor = grad.detach().float().cpu().numpy()
        return stor[0] + 1j * stor[1]

    def grad_explained(self, grads: np.ndarray) -> None:
        """One more mode when the accumulated gradient's spectrum is not
        explained by the current modes less ``incremental_buffer``."""
        g = np.asarray(grads)
        if self.accumulated_grad is None:
            self.accumulated_grad = np.zeros_like(g)
        ndim = len(self.current_n_modes)
        if self.grad_iter <= self.incremental_grad_max_iter:
            self.grad_iter += 1
            self.accumulated_grad = self.accumulated_grad + g
            return
        modes = self.current_n_modes[0]
        weight = self.accumulated_grad
        strength = [float(np.linalg.norm(weight[:, m]))
                    for m in range(min(weight.shape[1], modes))]
        ratio = compute_explained_variance(modes - self.incremental_buffer, strength)
        if ratio < self.incremental_grad_eps and modes < self.max_modes[0]:
            modes += 1
        self.grad_iter = 1
        self.accumulated_grad = np.zeros_like(weight)
        self.current_n_modes = tuple([modes] * ndim)


__all__ = ["IncrementalFNOTrainer"]
