"""AdamW and learning-rate schedules (port of ``neuraloperator_tpu/training/optimizer.py``).

The JAX package builds optax transformations; the port builds an
:class:`AdamWTransform`, a description of the optimizer that the
``Trainer`` binds to the model's parameters (:meth:`AdamWTransform.bind`),
giving an :class:`AdamW` ``torch.optim.Optimizer``. Both state policies of
the JAX ``adamw`` are ported in plain tensor ops with optax's order of
operations:

* ``factored_second_moment=False``: ``optax.adamw`` (full f32 second
  moment; ``mu_dtype`` stores the first moment);
* ``factored_second_moment=True``: ``scale_by_adam_factored``, the
  Adafactor-style second moment of leaves with two or more dims kept as its
  row and column means over the last two axes (f32 always), then
  ``add_decayed_weights`` and ``scale_by_learning_rate``.

The update is ``-lr(count) * (adam + weight_decay * p)``, with the
schedule read at the step count before the increment (the first update
uses ``lr(0)``), then cast to the parameter's dtype and scaled by the
``Trainer``'s per-epoch factor in f32. The port keeps the JAX parameter
layouts (``convert.py``), so "the last two axes" are the same axes in both
packages.
"""

from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from .._common import not_ported

Schedule = Callable[[int], float]


def step_lr(base_lr: float, step_size: int, gamma: float = 0.5,
            steps_per_epoch: int = 1) -> Schedule:
    """Staircase decay by ``gamma`` every ``step_size`` epochs, as a schedule
    of the update count (``optax.exponential_decay(staircase=True)``)."""
    transition = step_size * steps_per_epoch
    if transition <= 0:
        raise ValueError(f"step_size * steps_per_epoch must be positive, got {transition}")

    def schedule(count: int) -> float:
        return base_lr * gamma ** (count // transition)

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in f32, as optax forms it: with ``decay``
    rounded to f32 first (for 0.999 that alone moves ``1 - decay`` by
    1.3e-5 relative from its value in double)."""
    one, d = np.float32(1.0), np.float32(decay)
    return float(one - d ** np.float32(count))


def _is_factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


class AdamW(torch.optim.Optimizer):
    """AdamW with optax's semantics, full or factored second moment.

    ``step(lr_scale=...)`` applies one update from the parameters'
    ``.grad``; ``lr_scale`` is the per-epoch scheduler factor the
    ``Trainer`` multiplies every update by (in f32, after the cast to the
    parameter's dtype, as the JAX ``Trainer`` does). A parameter without a
    gradient (``.grad`` is None, as for one that does not reach the loss)
    takes a zero gradient, as optax gives every leaf one: weight decay and
    the decaying moments still move it.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        learning_rate: Union[float, Schedule],
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        mu_dtype: Optional[torch.dtype] = None,
        factored_second_moment: bool = False,
    ):
        defaults = dict(weight_decay=weight_decay, betas=tuple(betas), eps=eps)
        super().__init__(params, defaults)
        self.learning_rate = learning_rate
        self.mu_dtype = mu_dtype
        self.factored = factored_second_moment
        self.count = 0  # optax's shared step count

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def _init_state(self, p: torch.Tensor) -> dict:
        # second-moment statistics are f32 whatever the parameter's dtype
        f32 = dict(dtype=torch.float32, device=p.device)
        state = {"mu": torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)}
        if self.factored and _is_factored(p):
            state["nu_row"] = torch.zeros(p.shape[:-1], **f32)
            state["nu_col"] = torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
        else:
            state["nu"] = torch.zeros(p.shape, **f32)
        return state

    @torch.no_grad()
    def step(self, closure=None, lr_scale: float = 1.0):
        if closure is not None:
            raise not_ported("AdamW.step(closure)", "the rest of losses, training and data")
        lr = self._lr(self.count)  # the schedule sees the count before the increment
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1c, b2c = (_bias_correction(b, self.count) for b in (b1, b2))
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                u = self._adam_direction(g, state, b1, b2, b1c, b2c, group["eps"])
                # add_decayed_weights, then scale_by_learning_rate
                u = u + group["weight_decay"] * p
                u = -lr * u
                # with_final_update_cast: the update takes the parameter's
                # dtype; a no-op for the f32 parameters the port trains
                u = u.to(p.dtype)
                p.add_((u.float() * lr_scale).to(u.dtype))

    def _adam_direction(self, g, state, b1, b2, b1c, b2c, eps) -> torch.Tensor:
        """The scaled Adam direction ``m_hat / (sqrt(v_hat) + eps)``, updating the state."""
        mu = state["mu"]
        if self.factored:
            # scale_by_adam_factored stores mu in its dtype and reads it back
            # from there, so a bf16 mu feeds the update rounded
            mu.copy_(b1 * mu.to(g.dtype) + (1 - b1) * g)
            m = mu
        else:
            # optax.scale_by_adam feeds the update the unrounded moment
            m = (1 - b1) * g + b1 * mu.to(g.dtype)
            mu.copy_(m)
        g32 = g.float()
        if "nu" in state:
            nu = state["nu"]
            if self.factored:
                nu.copy_(b2 * nu + (1 - b2) * g32 * g32)
            else:
                nu.copy_((1 - b2) * g32 ** 2 + b2 * nu)
            v = nu
        else:
            r, c = state["nu_row"], state["nu_col"]
            g2 = g32 * g32
            r.copy_(b2 * r + (1 - b2) * torch.mean(g2, dim=-1))
            c.copy_(b2 * c + (1 - b2) * torch.mean(g2, dim=-2))
            # rank-1 reconstruction V ~= R C^T / mean(R)
            r_mean = torch.mean(r, dim=-1, keepdim=True)
            v = r[..., :, None] * c[..., None, :] / (r_mean[..., None] + 1e-30)
        m_hat = m.float() / b1c
        return m_hat / (torch.sqrt(v / b2c) + eps)


class AdamWTransform:
    """What ``adamw`` returns: the optimizer's settings, bound by the ``Trainer``.

    ``bind(params)`` gives the :class:`AdamW` that updates ``params``; the
    state lives there, as optax's state lives in the JAX ``Trainer``.
    """

    def __init__(self, **settings):
        self.settings = settings

    def bind(self, params: Iterable[torch.Tensor]) -> AdamW:
        return AdamW(params, **self.settings)


def adamw(
    learning_rate: Union[float, Schedule],
    weight_decay: float = 0.0,
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = None,
    mu_dtype=None,
    factored_second_moment: bool = False,
    cast_final_updates: bool = True,
) -> AdamWTransform:
    """AdamW with torch's defaults; see the module docstring for the policies.

    ``mu_dtype`` is None (the parameter's dtype) or ``torch.bfloat16``.
    ``cast_final_updates`` casts each update to its parameter's dtype,
    which for the f32 parameters of the port is a no-op either way.
    """
    if max_grad_norm is not None:
        raise not_ported("adamw max_grad_norm", "the rest of losses, training and data")
    if mu_dtype == "int8":
        raise not_ported("adamw mu_dtype='int8' (factored8)", "factored8/EMA/SR")
    if mu_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"mu_dtype must be None or torch.bfloat16, got {mu_dtype!r}")
    del cast_final_updates  # see the docstring
    return AdamWTransform(
        learning_rate=learning_rate, weight_decay=weight_decay, betas=betas,
        eps=eps, mu_dtype=mu_dtype, factored_second_moment=factored_second_moment,
    )


def build_optimizer(opt_config, steps_per_epoch: int = 1) -> AdamWTransform:
    """The optimizer of an ``OptConfig``-like section (attributes
    ``learning_rate``, ``step_size``, ``gamma``, ``weight_decay``,
    ``opt_state``): AdamW with the StepLR schedule folded in.

    Policies ``"full"`` (f32 moments) and ``"factored"`` (factored second
    moment, bf16 first moment) are ported; ``"factored8"``, EMA and
    stochastic rounding raise.
    """
    policy = getattr(opt_config, "opt_state", "full")
    if policy == "factored8":
        raise not_ported("opt_state='factored8'", "factored8/EMA/SR")
    if policy not in ("full", "factored"):
        raise ValueError(f"unknown opt.opt_state: {policy!r}")
    if getattr(opt_config, "ema_decay", 0.0) > 0:
        raise not_ported("opt.ema_decay", "factored8/EMA/SR")
    if getattr(opt_config, "stochastic_rounding", False):
        raise not_ported("opt.stochastic_rounding", "factored8/EMA/SR")
    return adamw(
        step_lr(
            opt_config.learning_rate,
            opt_config.step_size,
            getattr(opt_config, "gamma", 0.5),
            steps_per_epoch,
        ),
        weight_decay=opt_config.weight_decay,
        factored_second_moment=policy == "factored",
        mu_dtype={"full": None, "factored": torch.bfloat16}[policy],
    )


class StepLR:
    """The per-epoch scheduler protocol of ``Trainer.train(scheduler=...)``.

    The ``Trainer`` calls ``step()`` after every epoch and multiplies every
    update by ``factor = gamma ** (epoch // step_size)``. Use it with an
    optimizer built on a constant learning rate.
    """

    needs_metric = False

    def __init__(self, step_size: int, gamma: float = 0.5):
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        self.epoch = 0
        self.factor = 1.0

    def step(self, metric=None) -> None:
        self.epoch += 1
        self.factor = self.gamma ** (self.epoch // self.step_size)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "factor": self.factor}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.factor = float(state["factor"])



__all__ = ["AdamW", "AdamWTransform", "StepLR", "adamw", "build_optimizer", "step_lr"]
