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

The step count, the learning rate and the bias corrections live in device
tensors and are updated by device ops inside ``step``, as optax computes
them (f32 arithmetic on an int32 count): a step reads nothing back to the
host, so a CUDA graph can capture it and every replay sees the count of its
own step. ``state_dict`` and ``load_state_dict`` speak optax's state tree
(``convert.adamw_state_to_optax``), so the port and the JAX package resume
each other's ``optimizer.msgpack``.
"""

import functools
from typing import Callable, Iterable, Optional, Sequence, Union

import torch

from .._common import not_ported
from ..convert import adamw_state_from_optax, adamw_state_to_optax

Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


class StepLRSchedule:
    """Staircase decay by ``gamma`` every ``transition`` updates.

    Called with a Python int it gives a float; called with the optimizer's
    int32 count tensor it gives an f32 tensor on the count's device, formed
    as ``optax.exponential_decay(staircase=True)`` forms it:
    ``base * gamma ** floor(f32(count) / transition)`` in f32 (the count is
    never negative, so optax's ``where(count <= 0, base, ...)`` is the
    same value).
    """

    def __init__(self, base_lr: float, transition: int, gamma: float):
        if transition <= 0:
            raise ValueError(f"step_size * steps_per_epoch must be positive, got {transition}")
        self.base_lr, self.transition, self.gamma = base_lr, transition, gamma

    def __call__(self, count):
        if isinstance(count, torch.Tensor):
            p = torch.floor(count.float() / self.transition)
            return self.base_lr * torch.pow(self.gamma, p)
        return self.base_lr * self.gamma ** (count // self.transition)


def step_lr(base_lr: float, step_size: int, gamma: float = 0.5,
            steps_per_epoch: int = 1) -> StepLRSchedule:
    """Staircase decay by ``gamma`` every ``step_size`` epochs, as a schedule
    of the update count (``optax.exponential_decay(staircase=True)``)."""
    return StepLRSchedule(base_lr, step_size * steps_per_epoch, gamma)


def _is_factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX casts a Python scalar to the dtype
    of the array it multiplies, so a bf16 gradient meets bf16 constants."""
    return float(torch.tensor(value, dtype=dtype))


class AdamW(torch.optim.Optimizer):
    """AdamW with optax's semantics, full or factored second moment.

    ``step(lr_scale=...)`` applies one update from the parameters'
    ``.grad``; ``lr_scale`` (a float or an f32 0-d tensor on the
    parameters' device) is the per-epoch scheduler factor the ``Trainer``
    multiplies every update by (in f32, after the cast to the parameter's
    dtype, as the JAX ``Trainer`` does). A parameter without a gradient
    (``.grad`` is None, as for one that does not reach the loss) takes a
    zero gradient, as optax gives every leaf one: weight decay and the
    decaying moments still move it.

    ``count`` is an int32 0-d tensor on the parameters' device, and every
    parameter's state is made when the optimizer is: a step allocates no
    state and synchronises with nothing. ``names`` (one per parameter, the
    ``state_dict`` names the JAX parameter tree uses) are needed only by
    ``state_dict`` and ``load_state_dict``.
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
        names: Optional[Sequence[str]] = None,
    ):
        params = list(params)
        if names is not None and len(names) != len(params):
            raise ValueError(f"{len(names)} names for {len(params)} parameters")
        defaults = dict(weight_decay=weight_decay, betas=tuple(betas), eps=eps)
        super().__init__(params, defaults)
        self.learning_rate = learning_rate
        self.mu_dtype = mu_dtype
        self.factored = factored_second_moment
        self.names = None if names is None else list(names)
        device = params[0].device
        # optax's shared step count; the rate and the bias corrections
        # (1 - b1 ** count, 1 - b2 ** count) of the last step
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.bias_correction = torch.zeros(2, dtype=torch.float32, device=device)
        for p in params:
            self.state[p].update(self._init_state(p))

    def _set_lr(self) -> None:
        """``self.lr`` := the rate at the current count (f32, on the device)."""
        lr = self.learning_rate
        if callable(lr):
            lr = lr(self.count)
        if isinstance(lr, torch.Tensor):
            self.lr.copy_(lr)
        else:
            self.lr.fill_(lr)

    def _init_state(self, p: torch.Tensor) -> dict:
        # as the JAX Trainer builds the optax state from the f32-promoted
        # parameters: a bf16 parameter gets an f32 first moment unless
        # mu_dtype says otherwise, and the second moment is f32 always
        f32 = dict(dtype=torch.float32, device=p.device)
        state = {"mu": torch.zeros_like(p, dtype=self.mu_dtype or torch.float32)}
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
        self._set_lr()  # the schedule sees the count before the increment
        lr = self.lr
        self.count.add_(1)
        count = self.count.float()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            # 1 - decay ** count in f32, with decay rounded to f32 as optax
            # rounds it (for 0.999 that alone moves 1 - decay by 1.3e-5
            # relative from its value in double)
            for k, b in enumerate((b1, b2)):
                self.bias_correction[k].copy_(1 - torch.pow(b, count))
            b1c, b2c = self.bias_correction[0], self.bias_correction[1]
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                u = self._adam_direction(g, self.state[p], b1, b2, b1c, b2c, group["eps"])
                # add_decayed_weights, then scale_by_learning_rate
                u = u + _rounded(group["weight_decay"], p.dtype) * p
                u = -lr * u
                # with_final_update_cast: the update takes the parameter's
                # dtype (bf16 for bf16-stored weights) and is added in it
                u = u.to(p.dtype)
                p.add_((u.float() * lr_scale).to(u.dtype))

    def _adam_direction(self, g, state, b1, b2, b1c, b2c, eps) -> torch.Tensor:
        """The scaled Adam direction ``m_hat / (sqrt(v_hat) + eps)``, updating the state."""
        mu = state["mu"]
        # each term in its operand's dtype, its constant rounded to it: for a
        # bf16 parameter's gradient, (1 - b1) * g is a bf16 product
        b1_g, b1c_g = _rounded(b1, g.dtype), _rounded(1 - b1, g.dtype)
        if self.factored:
            # scale_by_adam_factored stores mu in its dtype and reads it back
            # from there, so a bf16 mu feeds the update rounded
            mu.copy_(b1_g * mu.to(g.dtype) + b1c_g * g)
            m = mu
        else:
            # optax.scale_by_adam feeds the update the unrounded moment; the
            # sum takes the promoted dtype
            mu_p = mu.to(torch.promote_types(g.dtype, mu.dtype))
            m = b1c_g * g + _rounded(b1, mu_p.dtype) * mu_p
            mu.copy_(m)
        g32 = g.float()
        if "nu" in state:
            nu = state["nu"]
            if self.factored:
                nu.copy_(b2 * nu + (1 - b2) * g32 * g32)
            else:
                nu.copy_(_rounded(1 - b2, g.dtype) * g ** 2 + b2 * nu)
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

    def _named_states(self):
        if self.names is None:
            raise ValueError("this AdamW was made without parameter names; bind it with "
                             "named parameters to save or load its state")
        return dict(zip(self.names, (self.state[p] for p in self.param_groups[0]["params"])))

    def state_dict(self) -> dict:
        """The state as optax's state tree (``convert.adamw_state_to_optax``):
        the tree the JAX package saves as ``optimizer.msgpack``. Its leaves
        are this optimizer's own tensors, not copies."""
        return adamw_state_to_optax(int(self.count), self._named_states(), self.factored)

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Copy an optax state tree (``state_dict``'s layout, with arrays or
        tensors of the same names and shapes) into this optimizer's state."""
        states = self._named_states()
        count, loaded = adamw_state_from_optax(state_dict, states, self.factored)
        self.count.fill_(count)
        for name, state in states.items():
            for key, value in loaded[name].items():
                state[key].copy_(value)


class AdamWTransform:
    """What ``adamw`` returns: the optimizer's settings, bound by the ``Trainer``.

    ``bind(params)`` gives the :class:`AdamW` that updates ``params``; the
    state lives there, as optax's state lives in the JAX ``Trainer``.
    """

    def __init__(self, **settings):
        self.settings = settings

    def bind(self, params) -> AdamW:
        """``params``: tensors, or ``(name, tensor)`` pairs such as
        ``model.named_parameters()`` (needed to save and load the state)."""
        params = list(params)
        if params and isinstance(params[0], tuple):
            names, params = zip(*params)
            return AdamW(params, names=names, **self.settings)
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

    ``mu_dtype`` is None (f32, the dtype of the f32-promoted parameter the
    JAX Trainer builds the state from) or ``torch.bfloat16``.
    Each update is cast to its parameter's dtype before it is added
    (``with_final_update_cast``); ``cast_final_updates=False``, which the
    JAX package sets only for stochastic rounding, raises.
    """
    if max_grad_norm is not None:
        raise not_ported("adamw max_grad_norm", "the rest of losses, training and data")
    if mu_dtype == "int8":
        raise not_ported("adamw mu_dtype='int8' (factored8)", "factored8/EMA/SR")
    if not cast_final_updates:
        raise not_ported("adamw cast_final_updates=False", "factored8/EMA/SR")
    if mu_dtype not in (None, torch.bfloat16, torch.float32):
        raise ValueError(f"mu_dtype must be None or torch.bfloat16, got {mu_dtype!r}")
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



__all__ = ["AdamW", "AdamWTransform", "StepLR", "StepLRSchedule", "adamw", "build_optimizer",
           "step_lr"]
