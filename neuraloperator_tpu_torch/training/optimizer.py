"""AdamW and learning-rate schedules (port of ``neuraloperator_tpu/training/optimizer.py``).

The JAX package builds optax transformations; the port builds an
:class:`AdamWTransform`, a description of the optimizer that the
``Trainer`` binds to the model's parameters (:meth:`AdamWTransform.bind`),
giving an :class:`AdamW` ``torch.optim.Optimizer``. Every state policy of
the JAX ``adamw`` is ported in plain tensor ops with optax's order of
operations:

* ``factored_second_moment=False``: ``optax.adamw`` (full f32 second
  moment; ``mu_dtype`` stores the first moment);
* ``factored_second_moment=True``: ``scale_by_adam_factored``, the
  Adafactor-style second moment of leaves with two or more dims kept as its
  row and column means over the last two axes (f32 always), then
  ``add_decayed_weights`` and ``scale_by_learning_rate``; with
  ``mu_dtype="int8"`` the first moment of those leaves is stored as
  blockwise int8 codes with one f32 scale per block
  (:func:`quantize_blockwise`), the others' in bf16.

The update is ``-lr(count) * (adam + weight_decay * p)``, with the
schedule read at the step count before the increment (the first update
uses ``lr(0)``), then cast to the parameter's dtype
(``cast_final_updates``) and scaled by the ``Trainer``'s per-epoch factor
in f32. The port keeps the JAX parameter layouts (``convert.py``), so "the
last two axes" are the same axes in both packages. Two options of the JAX
package ride on the same optimizer: stochastic rounding of bf16 parameters
(``step(generator=...)``, :func:`apply_updates_sr`) and an EMA of the
parameters (:func:`with_ema`, :func:`ema_params`). ``max_grad_norm`` clips
the gradients by their global norm before everything else
(``optax.clip_by_global_norm`` chained in front), and
:func:`reduce_on_plateau` scales every update by a factor that falls when
the loss given to ``step(value=...)`` stops improving
(``optax.contrib.reduce_on_plateau`` chained behind). The per-epoch
schedulers :class:`StepLR` and :class:`ReduceLROnPlateau` follow the
``Trainer``'s epoch protocol instead.

Bound to a model-sharded model's parameters (``parallel.mesh.shard_params``;
``bind(..., model_parallel=mesh.model_parallel_layout(model))``), each
sliced leaf's state is its slice too, and the update is the whole leaf's
update restricted to the slice: the global gradient norm sums the sliced
leaves' squares over the model group once and counts the others once; a
factored second moment whose row or column mean runs over the sliced dim
(a factorized ``w_factor_1``'s out channels are one of its last two axes)
takes that mean, and ``r_mean``, over the group; an int8 first moment,
whose blocks of the flattened leaf straddle the slices, stays whole on
every rank and is updated from the gathered gradient. ``state_dict``
gathers the slices to the whole tree and ``load_state_dict`` cuts it.

The step count, the learning rate and the bias corrections live in device
tensors and are updated by device ops inside ``step``, as optax computes
them (f32 arithmetic on an int32 count): a step reads nothing back to the
host, so a CUDA graph can capture it and every replay sees the count of its
own step. ``state_dict`` and ``load_state_dict`` speak optax's state tree
(``convert.adamw_state_to_optax``), so the port and the JAX package resume
each other's ``optimizer.msgpack``; with the clip and the plateau scale the
tree is that of ``reduce_on_plateau(with_ema(adamw(..., max_grad_norm)))``,
each wrapper present only when its option is.
"""

import functools
import math
import warnings
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..convert import adamw_state_from_optax, adamw_state_to_optax
from ..parallel import comm

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


class CosineAnnealingSchedule:
    """Cosine decay from ``base_lr`` to 0 over ``decay_steps`` updates, then 0.

    Called with a Python int it gives a float; called with the optimizer's
    int32 count tensor it gives an f32 tensor on the count's device (no
    host read, so a CUDA graph can capture it), formed as
    ``optax.cosine_decay_schedule`` forms it with alpha 0 and exponent 1:
    ``base * 0.5 * (1 + cos(pi * min(count, T) / T))`` in f32.
    """

    def __init__(self, base_lr: float, decay_steps: int):
        if not decay_steps > 0:
            raise ValueError(f"cosine annealing needs positive decay steps, got {decay_steps}")
        self.base_lr, self.decay_steps = base_lr, decay_steps

    def __call__(self, count):
        T = self.decay_steps
        if isinstance(count, torch.Tensor):
            c = torch.clamp(count.float(), max=float(T))
            return self.base_lr * (0.5 * (1 + torch.cos(math.pi * c / T)))
        return self.base_lr * 0.5 * (1 + math.cos(math.pi * min(count, T) / T))


def cosine_annealing(base_lr: float, t_max: int,
                     steps_per_epoch: int = 1) -> CosineAnnealingSchedule:
    """Cosine annealing over ``t_max`` epochs of ``steps_per_epoch`` updates
    (``optax.cosine_decay_schedule(base_lr, t_max * steps_per_epoch)``)."""
    return CosineAnnealingSchedule(base_lr, t_max * steps_per_epoch)


class Quantized8(NamedTuple):
    """A tensor as blockwise int8: ``codes`` (n_blocks, block) int8 and one
    f32 absmax ``scale`` (n_blocks, 1) per block. The shape is not stored;
    the matching parameter gives it."""

    codes: torch.Tensor
    scale: torch.Tensor


def quantize_blockwise(x: torch.Tensor, block: int = 2048) -> Quantized8:
    """``x`` as symmetric absmax-scaled int8 blocks of ``block`` elements,
    zero-padded, with the JAX package's order of operations (``inv =
    where(absmax > 0, 127 / absmax, 0)`` multiplied into the block, then
    rounded half to even), so the codes equal its codes to the bit."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = absmax / 127.0
    inv = torch.where(absmax > 0, 127.0 / absmax, torch.zeros_like(absmax))
    return Quantized8(codes=torch.round(blocks * inv).to(torch.int8), scale=scale)


def dequantize_blockwise(q: Quantized8, shape) -> torch.Tensor:
    """The f32 tensor of ``shape`` that ``q`` encodes (up to rounding)."""
    size = 1
    for s in shape:
        size *= s
    return (q.codes.float() * q.scale).reshape(-1)[:size].reshape(shape)


def round_bf16_with_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of f32 ``x`` to bf16 given its noise: ``noise``
    (integers in [0, 2**16), ``x``'s shape) is added to the f32 bit pattern
    and the low 16 bits are dropped, as ``stochastic_round_to`` does with
    ``jax.random.bits``. In int32 the add wraps as JAX's uint32 add does,
    and the arithmetic shift differs from the logical one only in the bits
    the cast to int16 drops."""
    bits = x.float().contiguous().view(torch.int32) + noise.to(torch.int32)
    return (bits >> 16).to(torch.int16).view(torch.bfloat16)


def stochastic_round_to(dtype: torch.dtype, x: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
    """``x`` rounded stochastically to bf16: up with probability equal to the
    discarded fraction, so ``E[sr(x)] = x``. The 16 noise bits per element
    are drawn from ``generator`` (on ``x``'s device); their values are not
    JAX's, whose ``jax.random`` bits torch cannot draw."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("stochastic rounding targets bfloat16")
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device,
                          dtype=torch.int32)
    return round_bf16_with_noise(x, noise)


_SR_WARNING = ("apply_updates_sr received bf16 updates for bf16 params — pass "
               "cast_final_updates=False to the optimizer so stochastic rounding sees "
               "full-precision updates")


def _apply_update(p: torch.Tensor, u: torch.Tensor,
                  generator: Optional[torch.Generator]) -> None:
    """``p`` += ``u`` in place: stochastically rounded into a bf16 ``p`` when
    ``generator`` is given, else ``optax.apply_updates`` (the sum in the
    promoted dtype, cast to ``p``'s)."""
    if generator is not None and p.dtype == torch.bfloat16:
        p.copy_(stochastic_round_to(torch.bfloat16, p.float() + u.float(), generator))
    elif u.dtype == p.dtype:
        p.add_(u)
    else:
        p.copy_((p + u).to(p.dtype))


@torch.no_grad()
def apply_updates_sr(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor],
                     generator: torch.Generator) -> None:
    """Add each update to its parameter in place, bf16 parameters through
    stochastic rounding of the f32 sum and the others by a plain add.
    Warns (once per call, as the JAX function does) when a bf16 parameter
    gets a bf16 update: it was already rounded to nearest."""
    warned = False
    for p, u in zip(params, updates):
        if p.dtype == torch.bfloat16 and u.dtype == torch.bfloat16 and not warned:
            warnings.warn(_SR_WARNING, stacklevel=2)
            warned = True
        _apply_update(p, u if p.dtype == torch.bfloat16 else u.to(p.dtype), generator)


def _is_factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def _state_dim(key: str, dim: int, ndim: int) -> Optional[int]:
    """The dim of a state tensor ``key`` that holds a parameter's sliced
    ``dim`` (``ndim`` the parameter's), or None where the state is whole:
    the factored means drop an axis, the int8 blocks are kept whole."""
    if key in ("mu_codes", "mu_scale"):
        return None
    if key == "nu_row":
        return dim if dim < ndim - 1 else None
    if key == "nu_col":
        if dim == ndim - 2:
            return None
        return dim if dim < ndim - 2 else ndim - 2
    return dim


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX casts a Python scalar to the dtype
    of the array it multiplies, so a bf16 gradient meets bf16 constants."""
    return float(torch.tensor(value, dtype=dtype))


class AdamW(torch.optim.Optimizer):
    """AdamW with optax's semantics: full, factored or factored-int8 state.

    ``step(lr_scale=..., generator=...)`` applies one update from the
    parameters' ``.grad``; ``lr_scale`` (a float or an f32 0-d tensor on the
    parameters' device) is the per-epoch scheduler factor the ``Trainer``
    multiplies every update by (in f32, after the cast to the parameter's
    dtype, as the JAX ``Trainer`` does); with a ``generator``, bf16
    parameters take their update by stochastic rounding. A parameter
    without a gradient (``.grad`` is None, as for one that does not reach
    the loss) takes a zero gradient, as optax gives every leaf one: weight
    decay and the decaying moments still move it.

    ``ema_decay`` keeps an f32 EMA of the parameters in the state
    (``with_ema``): each step folds in the parameters it is given, before
    their update and the ``Trainer``'s ``lr_scale``, a one-step lag.

    ``max_grad_norm`` scales every gradient by ``max_grad_norm / g_norm``
    when the global l2 norm ``g_norm`` of all of them reaches it
    (``optax.clip_by_global_norm``, ahead of every other transformation).
    ``plateau`` (:func:`reduce_on_plateau`'s settings) multiplies each update
    by a scale that falls by ``factor`` after ``patience`` steps whose
    ``value`` (the loss, passed as ``step(value=...)``) did not improve on
    the best by ``rtol`` and ``atol``; the arithmetic is optax's, on device
    tensors. ``step(closure)`` follows torch's protocol: the closure runs
    with gradients enabled before the update and its loss is returned.

    ``count`` is an int32 0-d tensor on the parameters' device, and every
    parameter's state is made when the optimizer is: a step allocates no
    state and synchronises with nothing. ``names`` (one per parameter, the
    ``state_dict`` names the JAX parameter tree uses) are needed only by
    ``state_dict`` and ``load_state_dict``, and by ``model_parallel``
    (``(group, {name: dim})``: the parameters held as slices of ``dim``
    over ``group``; see the module docstring).
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        learning_rate: Union[float, Schedule],
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        mu_dtype=None,
        factored_second_moment: bool = False,
        cast_final_updates: bool = True,
        ema_decay: Optional[float] = None,
        max_grad_norm: Optional[float] = None,
        plateau: Optional[dict] = None,
        names: Optional[Sequence[str]] = None,
        model_parallel=None,
    ):
        params = list(params)
        if names is not None and len(names) != len(params):
            raise ValueError(f"{len(names)} names for {len(params)} parameters")
        # the model-sharded leaves: {parameter: sliced dim} over model_group
        self.model_group, self.model_dims = None, {}
        if model_parallel is not None:
            if names is None:
                raise ValueError("a model-parallel AdamW needs the parameters' names")
            self.model_group, dims = model_parallel
            self.model_dims = {p: dims[n] for n, p in zip(names, params) if n in dims}
        defaults = dict(weight_decay=weight_decay, betas=tuple(betas), eps=eps)
        super().__init__(params, defaults)
        self.learning_rate = learning_rate
        self.mu_int8 = mu_dtype == "int8"
        self.mu_dtype = None if self.mu_int8 else mu_dtype
        self.factored = factored_second_moment
        self.cast_final_updates = cast_final_updates
        self.ema_decay = ema_decay
        self.max_grad_norm = max_grad_norm
        self.plateau = None if plateau is None else dict(plateau)
        self.needs_value = plateau is not None
        self.names = None if names is None else list(names)
        device = params[0].device
        # optax's shared step count; the rate and the bias corrections
        # (1 - b1 ** count, 1 - b2 ** count) of the last step
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.bias_correction = torch.zeros(2, dtype=torch.float32, device=device)
        for p in params:
            self.state[p].update(self._init_state(p))
        if plateau is not None:
            # optax's ReduceLROnPlateauState: the scale in the parameters'
            # lowest float dtype, the rest f32 and int32
            lowest = min((p.dtype for p in params), key=lambda d: torch.finfo(d).bits)
            self.plateau_state = {
                "scale": torch.ones((), dtype=lowest, device=device),
                "best_value": torch.full((), float("inf"), device=device),
                "plateau_count": torch.zeros((), dtype=torch.int32, device=device),
                "cooldown_count": torch.zeros((), dtype=torch.int32, device=device),
                "count": torch.zeros((), dtype=torch.int32, device=device),
                "avg_value": torch.zeros((), device=device),
            }

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
        # mu_dtype says otherwise, the second moment is f32 always, and so
        # is the EMA
        f32 = dict(dtype=torch.float32, device=p.device)
        if self.mu_int8 and _is_factored(p):
            codes, scale = quantize_blockwise(torch.zeros(self._whole_shape(p), **f32))
            state = {"mu_codes": codes, "mu_scale": scale}
        elif self.mu_int8:  # small leaves keep a bf16 first moment
            state = {"mu": torch.zeros_like(p, dtype=torch.bfloat16)}
        else:
            state = {"mu": torch.zeros_like(p, dtype=self.mu_dtype or torch.float32)}
        if self.factored and _is_factored(p):
            state["nu_row"] = torch.zeros(p.shape[:-1], **f32)
            state["nu_col"] = torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
        else:
            state["nu"] = torch.zeros(p.shape, **f32)
        if self.ema_decay is not None:
            state["ema"] = p.detach().to(torch.float32, copy=True)
        return state

    def _whole_shape(self, p: torch.Tensor) -> tuple:
        """The shape of the whole leaf ``p`` is a slice of (its own if whole)."""
        shape = list(p.shape)
        if p in self.model_dims:
            shape[self.model_dims[p]] *= dist.get_world_size(self.model_group)
        return tuple(shape)

    def _global_norm(self) -> Optional[torch.Tensor]:
        """The gradients' global l2 norm (``optax.global_norm``), when
        clipping: a sliced leaf's squares summed over the model group."""
        if self.max_grad_norm is None:
            return None
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        sq = [(p.grad * p.grad).sum().float() for p in params if p not in self.model_dims]
        if not self.model_dims:
            return torch.sqrt(torch.stack(sq).sum())
        cut = torch.stack([(p.grad * p.grad).sum().float() for p in params
                           if p in self.model_dims]).sum()
        dist.all_reduce(cut, group=self.model_group)
        return torch.sqrt(cut + (torch.stack(sq).sum() if sq else torch.zeros_like(cut)))

    def _plateau_scale(self, value) -> torch.Tensor:
        """``optax.contrib.reduce_on_plateau``'s update with
        ``accumulation_size=1`` and no cooldown: the scale after ``value``."""
        st, cfg = self.plateau_state, self.plateau
        if value is None:
            raise ValueError("an optimizer under reduce_on_plateau needs step(value=loss)")
        # the running mean of one value is the value; count and mean restart
        value = torch.as_tensor(value, device=st["avg_value"].device).float()
        st["count"].zero_()
        st["avg_value"].zero_()
        improved = value < (1 - cfg["rtol"]) * st["best_value"] - cfg["atol"]
        st["best_value"].copy_(torch.where(improved, value, st["best_value"]))
        plateau = torch.where(improved, torch.zeros_like(st["plateau_count"]),
                              st["plateau_count"] + 1)
        hit = plateau == cfg["patience"]
        st["plateau_count"].copy_(torch.where(hit, torch.zeros_like(plateau), plateau))
        scale = st["scale"]
        scale.copy_(torch.where(hit, scale * cfg["factor"], scale))
        return scale

    @torch.no_grad()
    def step(self, closure=None, lr_scale: float = 1.0,
             generator: Optional[torch.Generator] = None, value=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
            if value is None and self.needs_value:
                value = loss.detach()
        g_norm = self._global_norm()
        plateau = self._plateau_scale(value) if self.plateau is not None else None
        self._set_lr()  # the schedule sees the count before the increment
        lr = self.lr
        self.count.add_(1)
        count = self.count.float()
        warned = False
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
                if g_norm is not None:
                    # clip_by_global_norm: select(norm < m, g, g / norm * m)
                    g = torch.where(g_norm < self.max_grad_norm, g,
                                    g / g_norm.to(g.dtype) * self.max_grad_norm)
                state = self.state[p]
                u = self._adam_direction(g, state, b1, b2, b1c, b2c, group["eps"],
                                         self.model_dims.get(p))
                # add_decayed_weights, then scale_by_learning_rate
                u = u + _rounded(group["weight_decay"], p.dtype) * p
                u = -lr * u
                if self.cast_final_updates:
                    # with_final_update_cast: the update takes the parameter's
                    # dtype (bf16 for bf16-stored weights) and is added in it
                    u = u.to(p.dtype)
                if plateau is not None:
                    u = plateau * u
                u = (u.float() * lr_scale).to(u.dtype)
                if "ema" in state:
                    # with_ema folds in the parameters given to the update
                    ema = state["ema"]
                    ema.copy_(self.ema_decay * ema
                              + _rounded(1 - self.ema_decay, p.dtype) * p)
                if (generator is not None and not warned and p.dtype == torch.bfloat16
                        and u.dtype == torch.bfloat16):
                    warnings.warn(_SR_WARNING, stacklevel=2)
                    warned = True
                _apply_update(p, u, generator)
        return loss

    def _mean(self, t: torch.Tensor, axis: int, sliced: bool, keepdim: bool = False):
        """``t``'s mean over ``axis``; over the model group's slices too when
        ``axis`` is the sliced one (equal slices: the mean of the means)."""
        m = torch.mean(t, dim=axis, keepdim=keepdim)
        if sliced:
            dist.all_reduce(m, group=self.model_group)
            m = m / dist.get_world_size(self.model_group)
        return m

    def _adam_direction(self, g, state, b1, b2, b1c, b2c, eps,
                        dim: Optional[int] = None) -> torch.Tensor:
        """The scaled Adam direction ``m_hat / (sqrt(v_hat) + eps)``, updating
        the state; ``dim``: the sliced dim of a model-sharded leaf."""
        if "mu_codes" in state:
            # scale_by_adam_factored's int8 branch: the EMA in f32 from the
            # dequantized moment; the unrounded moment feeds the update, the
            # quantized one is stored (in place: a captured graph replays it).
            # A slice's blocks are the whole leaf's: its gradient is gathered
            g32 = g.float()
            if dim is not None:
                g32 = comm.all_gather_along(g32, dim, self.model_group)
            codes, scale = state["mu_codes"], state["mu_scale"]
            m = b1 * dequantize_blockwise(Quantized8(codes, scale), g32.shape) + (1 - b1) * g32
            q = quantize_blockwise(m)
            codes.copy_(q.codes)
            scale.copy_(q.scale)
            if dim is not None:
                m = comm.own_slice(m, dim, self.model_group)
        elif self.mu_int8:
            mu = state["mu"]
            m = b1 * mu.float() + (1 - b1) * g.float()
            mu.copy_(m)
        elif self.factored:
            # scale_by_adam_factored stores mu in its dtype and reads it back
            # from there, so a bf16 mu feeds the update rounded. Each term in
            # its operand's dtype, its constant rounded to it: for a bf16
            # parameter's gradient, (1 - b1) * g is a bf16 product
            mu = state["mu"]
            mu.copy_(_rounded(b1, g.dtype) * mu.to(g.dtype) + _rounded(1 - b1, g.dtype) * g)
            m = mu
        else:
            # optax.scale_by_adam feeds the update the unrounded moment; the
            # sum takes the promoted dtype
            mu = state["mu"]
            mu_p = mu.to(torch.promote_types(g.dtype, mu.dtype))
            m = _rounded(1 - b1, g.dtype) * g + _rounded(b1, mu_p.dtype) * mu_p
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
            n = g.ndim
            r.copy_(b2 * r + (1 - b2) * self._mean(g2, -1, dim == n - 1))
            c.copy_(b2 * c + (1 - b2) * self._mean(g2, -2, dim == n - 2))
            # rank-1 reconstruction V ~= R C^T / mean(R)
            r_mean = self._mean(r, -1, dim == n - 2, keepdim=True)
            v = r[..., :, None] * c[..., None, :] / (r_mean[..., None] + 1e-30)
        m_hat = m.float() / b1c
        return m_hat / (torch.sqrt(v / b2c) + eps)

    def _named_states(self):
        if self.names is None:
            raise ValueError("this AdamW was made without parameter names; bind it with "
                             "named parameters to save or load its state")
        return dict(zip(self.names, (self.state[p] for p in self.param_groups[0]["params"])))

    def _sliced_keys(self):
        """``(name, state, {key: dim})`` of each model-sharded leaf: the dims
        of its state tensors that hold slices."""
        for name, p in zip(self.names or (), self.param_groups[0]["params"]):
            if p in self.model_dims:
                state = self.state[p]
                dims = {k: _state_dim(k, self.model_dims[p], p.ndim) for k in state}
                yield name, state, {k: d for k, d in dims.items() if d is not None}

    def _whole_states(self) -> dict:
        """``_named_states`` with every slice all-gathered over the model
        group (every model rank must call it)."""
        states = self._named_states()
        for name, state, dims in self._sliced_keys():
            states[name] = {k: (comm.all_gather_along(t, dims[k], self.model_group)
                                if k in dims else t) for k, t in state.items()}
        return states

    def cut_state(self) -> dict:
        """This rank's state for a sharded checkpoint
        (``training_state.save_training_state_orbax``): ``{"count": ...,
        "state": {name: {key: (tensor, data dim, model dim)}}}`` (and
        ``"plateau"``): the optimizer's own tensors, each with the dims
        along which it is a slice over the data and the model group (None:
        whole)."""
        sliced = {name: dims for name, _, dims in self._sliced_keys()}
        out = {"count": self.count, "state": {
            name: {k: (t, None, sliced.get(name, {}).get(k)) for k, t in state.items()}
            for name, state in self._named_states().items()}}
        if self.plateau is not None:
            out["plateau"] = dict(self.plateau_state)
        return out

    def state_dict(self) -> dict:
        """The state as optax's state tree (``convert.adamw_state_to_optax``):
        the tree the JAX package saves as ``optimizer.msgpack``. Its leaves
        are this optimizer's own tensors, not copies, but for a sliced
        leaf's, which are gathered to the whole leaf's."""
        tree = adamw_state_to_optax(int(self.count), self._whole_states(), self.factored,
                                    clipped=self.max_grad_norm is not None)
        if self.plateau is not None:
            tree = {"0": tree, "1": dict(self.plateau_state)}
        return tree

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Copy an optax state tree (``state_dict``'s layout, with arrays or
        tensors of the same names and shapes) into this optimizer's state."""
        states = self._named_states()
        if self.plateau is not None:
            if set(state_dict) != {"0", "1"} or set(state_dict["1"]) != set(self.plateau_state):
                raise ValueError("this optimizer keeps a reduce_on_plateau state; the tree "
                                 f"holds {sorted(state_dict)}")
            for key, value in state_dict["1"].items():
                self.plateau_state[key].copy_(torch.as_tensor(value))
            state_dict = state_dict["0"]
        template = dict(states)
        size = 1 if self.model_group is None else dist.get_world_size(self.model_group)
        for name, state, dims in self._sliced_keys():
            # the whole leaf's state is read on the host, then cut
            template[name] = {k: t.new_empty([s * size if d == dims.get(k) else s
                                              for d, s in enumerate(t.shape)], device="cpu")
                              if k in dims else t for k, t in state.items()}
        count, loaded = adamw_state_from_optax(state_dict, template, self.factored,
                                               clipped=self.max_grad_norm is not None)
        self.count.fill_(count)
        sliced = {name: dims for name, _, dims in self._sliced_keys()}
        for name, state in states.items():
            for key, value in loaded[name].items():
                if key in sliced.get(name, ()):
                    value = comm.own_slice(value.to(state[key].device), sliced[name][key],
                                           self.model_group)
                state[key].copy_(value)


class AdamWTransform:
    """What ``adamw`` returns: the optimizer's settings, bound by the ``Trainer``.

    ``bind(params)`` gives the :class:`AdamW` that updates ``params``; the
    state lives there, as optax's state lives in the JAX ``Trainer``.
    """

    def __init__(self, **settings):
        self.settings = settings

    def bind(self, params, model_parallel=None) -> AdamW:
        """``params``: tensors, or ``(name, tensor)`` pairs such as
        ``model.named_parameters()`` (needed to save and load the state, and
        by ``model_parallel``: ``parallel.mesh.model_parallel_layout`` of a
        sharded model)."""
        params = list(params)
        if params and isinstance(params[0], tuple):
            names, params = zip(*params)
            return AdamW(params, names=names, model_parallel=model_parallel, **self.settings)
        return AdamW(params, model_parallel=model_parallel, **self.settings)


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
    JAX Trainer builds the state from), ``torch.bfloat16``, or ``"int8"``
    (blockwise codes; factored path only). Each update is cast to its
    parameter's dtype before it is added (``with_final_update_cast``)
    unless ``cast_final_updates=False``, which stochastic rounding wants.
    ``max_grad_norm`` clips the gradients by their global norm first.
    """
    if mu_dtype == "int8" and not factored_second_moment:
        raise ValueError("mu_dtype='int8' requires factored_second_moment=True "
                         "(the blockwise-quantized mu lives in the factored kernel)")
    if mu_dtype not in (None, torch.bfloat16, torch.float32, "int8"):
        raise ValueError(f"mu_dtype must be None, torch.bfloat16 or 'int8', got {mu_dtype!r}")
    return AdamWTransform(
        learning_rate=learning_rate, weight_decay=weight_decay, betas=betas,
        eps=eps, mu_dtype=mu_dtype, factored_second_moment=factored_second_moment,
        cast_final_updates=cast_final_updates, max_grad_norm=max_grad_norm,
    )


def build_optimizer(opt_config, steps_per_epoch: int = 1) -> AdamWTransform:
    """The optimizer of an ``OptConfig``-like section (attributes
    ``learning_rate``, ``step_size``, ``gamma``, ``weight_decay``,
    ``opt_state``, ``stochastic_rounding``, ``ema_decay``): AdamW with the
    StepLR schedule folded in.

    Policies ``"full"`` (f32 moments), ``"factored"`` (factored second
    moment, bf16 first moment) and ``"factored8"`` (factored second moment,
    int8 first moment); stochastic rounding leaves the updates in f32 for
    the rounding; ``ema_decay > 0`` wraps it in :func:`with_ema`.
    """
    policy = getattr(opt_config, "opt_state", "full")
    if policy not in ("full", "factored", "factored8"):
        raise ValueError(f"unknown opt.opt_state: {policy!r}")
    tx = adamw(
        step_lr(
            opt_config.learning_rate,
            opt_config.step_size,
            getattr(opt_config, "gamma", 0.5),
            steps_per_epoch,
        ),
        weight_decay=opt_config.weight_decay,
        factored_second_moment=policy != "full",
        mu_dtype={"full": None, "factored": torch.bfloat16, "factored8": "int8"}[policy],
        # SR applies updates with its own stochastic round and wants the
        # full-precision update at the rounding point
        cast_final_updates=not getattr(opt_config, "stochastic_rounding", False),
    )
    if getattr(opt_config, "ema_decay", 0.0) > 0:
        tx = with_ema(tx, decay=opt_config.ema_decay)
    return tx


def with_ema(optimizer: AdamWTransform, decay: float = 0.999) -> AdamWTransform:
    """``optimizer`` keeping a Polyak/EMA copy of the parameters in its state:
    ``ema <- decay * ema + (1 - decay) * params``, folded in at each step
    from the parameters given to it (before their update and before the
    ``Trainer``'s ``lr_scale``: a one-step lag). The EMA starts at the
    parameters the optimizer is bound to, in f32, and rides the state, so
    checkpoints carry it (optax's ``EmaState(inner, ema)``). Read it back
    with :func:`ema_params`."""
    return AdamWTransform(**optimizer.settings, ema_decay=decay)


def ema_params(optimizer: AdamW) -> Dict[str, torch.Tensor]:
    """The EMA of a :func:`with_ema` optimizer: ``{name: f32 tensor}`` (the
    optimizer's own tensors; a model-sharded leaf's EMA is its slice, as
    the parameter is)."""
    if optimizer.ema_decay is None:
        raise TypeError("the optimizer does not carry an EMA — build it with with_ema(...)")
    return {name: state["ema"] for name, state in optimizer._named_states().items()}


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



class ReduceLROnPlateau:
    """The per-epoch protocol's plateau schedule: the ``Trainer`` calls
    ``step(train_err)`` after every epoch (``needs_metric``) and multiplies
    every update by ``factor``, which falls by ``reduction`` (never below
    ``min_factor``) once the metric has missed ``best * (1 - threshold)``
    more than ``patience`` epochs in a row. :func:`reduce_on_plateau` is the
    same idea folded into the optimizer, per step."""

    needs_metric = True

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 threshold: float = 1e-4, min_lr_factor: float = 0.0):
        self.reduction = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.min_factor = float(min_lr_factor)
        self.best = float("inf")
        self.bad_epochs = 0
        self.factor = 1.0

    def step(self, metric) -> None:
        metric = float(metric)
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.factor = max(self.factor * self.reduction, self.min_factor)
                self.bad_epochs = 0

    def state_dict(self) -> dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs, "factor": self.factor}

    def load_state_dict(self, state: dict) -> None:
        self.best = float(state["best"])
        self.bad_epochs = int(state["bad_epochs"])
        self.factor = float(state["factor"])


def reduce_on_plateau(optimizer: AdamWTransform, factor: float = 0.5, patience: int = 5,
                      atol: float = 0.0, rtol: float = 1e-4) -> AdamWTransform:
    """``optimizer`` with every update scaled by a plateau factor
    (``optax.chain(optimizer, optax.contrib.reduce_on_plateau(...))``): the
    scale falls by ``factor`` whenever ``patience`` consecutive steps' loss
    failed to beat ``(1 - rtol) * best - atol``. The bound optimizer takes the
    loss as ``step(value=...)``; the ``Trainer`` passes each step's loss (it
    reads the optimizer's ``needs_value``). The state stays on the device,
    so the staged step's CUDA graph replays it."""
    if not 0.0 < factor < 1.0:
        raise ValueError(f"Factor must be in the range (0, 1), got factor = {factor}.")
    if rtol < 0.0 or atol < 0.0 or (rtol == 0.0 and atol == 0.0) or rtol > 1.0:
        raise ValueError(f"need 0 <= rtol <= 1, atol >= 0 and one positive, got rtol = {rtol} "
                         f"and atol = {atol}")
    return AdamWTransform(**optimizer.settings, plateau=dict(
        factor=float(factor), patience=int(patience), atol=float(atol), rtol=float(rtol)))


__all__ = ["AdamW", "AdamWTransform", "Quantized8", "ReduceLROnPlateau", "StepLR",
           "StepLRSchedule", "adamw",
           "apply_updates_sr", "build_optimizer", "dequantize_blockwise", "ema_params",
           "quantize_blockwise", "reduce_on_plateau", "round_bf16_with_noise", "step_lr",
           "stochastic_round_to", "with_ema"]
