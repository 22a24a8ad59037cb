"""ZeRO-1: the optimizer state sharded over the data ranks (port of
``neuraloperator_tpu/parallel/zero.py``).

The JAX package annotates each optimizer-state leaf with a sharding
(:func:`zero_specs`: the leaf's largest dim that divides by the data size)
and lets XLA derive the schedule. Here :class:`ZeroAdamW` writes it out:
each data rank keeps its slice of every parameter's state (the first and
second moments, the factored row and column statistics, the EMA), updates
its slice of the parameter in place from its slice of the (all-reduced)
gradient, and all-gathers the parameter. The slices of the parameter and
of its gradient are views, so the cut state is the only memory that
changes. At data size 1 nothing is cut: the optimizer is the replicated
one. The slice of a parameter is cut along its
zero dim, which is the zero dim of each state leaf of the same shape; a
factored leaf's row and column statistics are cut along the same dim when
it lies before the two factored axes, where the update on a slice is the
update of the whole restricted to it. A parameter whose zero dim is one of
its two factored axes, or whose first moment is kept as int8 blocks over
its flattened entries, keeps its whole state on every rank: those updates
read the whole gradient. The flagship's spectral weights, nearly all of its
state, are cut.

``state_dict`` gathers the state to the whole tree the JAX files hold
(``optimizer.msgpack``), and ``load_state_dict`` takes that tree and keeps
this rank's slices, so a replicated run and a ZeRO run resume each other.
"""

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .comm import all_gather_along
from .mesh import DATA_AXIS

__all__ = ["ZeroAdamW", "shard_opt_state", "zero_specs"]


def _leaf_spec(shape, n: int) -> Optional[int]:
    """The largest dim divisible by ``n`` (the first of equals), or None:
    scalars and awkward shapes are a rounding error of the state."""
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n and (best is None or s > shape[best]):
            best = d
    return best


def zero_specs(tree, mesh, axis: str = DATA_AXIS):
    """``tree`` (nested dicts, lists and tuples of tensors or arrays) with
    each leaf replaced by the dim sharded over ``axis``, or None."""
    n = mesh.shape[axis]
    if isinstance(tree, dict):
        return {k: zero_specs(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zero_specs(v, mesh, axis) for v in tree)
    return _leaf_spec(tuple(getattr(tree, "shape", ())), n)


def shard_opt_state(opt_state, mesh, axis: str = DATA_AXIS):
    """Each leaf of ``opt_state`` cut to this data rank's slice along its
    :func:`zero_specs` dim (whole where that is None)."""
    if isinstance(opt_state, dict):
        return {k: shard_opt_state(v, mesh, axis) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)(shard_opt_state(v, mesh, axis) for v in opt_state)
    t = torch.as_tensor(opt_state)
    dim = _leaf_spec(tuple(t.shape), mesh.shape[axis])
    if dim is None:
        return t
    chunk = t.shape[dim] // mesh.shape[axis]
    return t.narrow(dim, mesh.data_rank * chunk, chunk).clone()


class ZeroAdamW:
    """The port's ``AdamW`` of ``transform`` over ``named_params`` with its
    state cut over the mesh's data group (see the module docstring).

    ``step`` takes the gradients already reduced over the data ranks, as
    the ``Trainer`` leaves them; the global gradient norm of
    ``max_grad_norm`` is summed over the slices. Stochastic rounding draws
    its noise for each slice, so it is not the replicated run's noise.
    """

    def __init__(self, transform, named_params, mesh):
        from ..training.optimizer import AdamW

        self.mesh = mesh
        self.group = mesh.data_group
        n, rank = mesh.shape[DATA_AXIS], mesh.data_rank
        settings = transform.settings
        factored = settings.get("factored_second_moment", False)
        int8 = settings.get("mu_dtype") == "int8"
        self.params, self.dims, local = [], [], []
        for name, p in named_params:
            dim = None if n == 1 else _leaf_spec(tuple(p.shape), n)
            if factored and p.ndim >= 2 and (int8 or dim is not None and dim >= p.ndim - 2):
                dim = None
            self.params.append((name, p))
            self.dims.append(dim)
            if dim is None:
                local.append((name, p))
            else:
                chunk = p.shape[dim] // n
                local.append((name, p.detach().narrow(dim, rank * chunk, chunk)))
        names, tensors = zip(*local)
        self.inner = AdamW(tensors, names=names, **settings)
        self.local = list(tensors)
        self.needs_value = self.inner.needs_value
        self.ema_decay = self.inner.ema_decay
        if any(d is not None for d in self.dims):
            self.inner._global_norm = self._global_norm

    def _slices(self):
        for (_, p), dim, loc in zip(self.params, self.dims, self.local):
            if dim is not None:
                yield p, dim, loc

    def _global_norm(self) -> Optional[torch.Tensor]:
        """The whole gradient's l2 norm: the cut leaves' squares summed over
        the data ranks, the whole ones counted once."""
        if self.inner.max_grad_norm is None:
            return None
        cut = [(t.grad.float() ** 2).sum() for d, t in zip(self.dims, self.local)
               if d is not None and t.grad is not None]
        whole = [(t.grad.float() ** 2).sum() for d, t in zip(self.dims, self.local)
                 if d is None and t.grad is not None]
        zero = self.local[0].new_zeros((), dtype=torch.float32)
        cut = torch.stack(cut).sum() if cut else zero.clone()
        dist.all_reduce(cut, group=self.group)
        return torch.sqrt(cut + (torch.stack(whole).sum() if whole else zero))

    @torch.no_grad()
    def step(self, closure=None, lr_scale: float = 1.0, generator=None, value=None):
        n, rank = self.mesh.shape[DATA_AXIS], self.mesh.data_rank
        for p, dim, loc in self._slices():
            chunk = p.shape[dim] // n
            loc.grad = None if p.grad is None else p.grad.narrow(dim, rank * chunk, chunk)
        loss = self.inner.step(closure, lr_scale=lr_scale, generator=generator, value=value)
        for p, dim, loc in self._slices():
            # every rank's slice into p: one slice-sized buffer per rank
            buf = loc.new_empty((n, *loc.shape))
            dist.all_gather(list(buf.unbind(0)), loc.contiguous(), group=self.group)
            p.view(*p.shape[:dim], n, loc.shape[dim], *p.shape[dim + 1:]).copy_(
                buf.movedim(0, dim))
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        for _, p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    # -- the whole state, as the replicated optimizer keeps it
    def _whole_states(self) -> Dict[str, dict]:
        states = {}
        for (name, p), dim, loc in zip(self.params, self.dims, self.local):
            state = self.inner.state[loc]
            if dim is None:
                states[name] = dict(state)
                continue
            whole = {}
            for key, t in state.items():
                whole[key] = all_gather_along(t, dim, self.group) if t.ndim > dim else t
            states[name] = whole
        return states

    def _named_states(self) -> Dict[str, dict]:
        return self._whole_states()

    def state_dict(self) -> dict:
        """The whole state as optax's tree (every rank joins the gathers)."""
        from ..convert import adamw_state_to_optax

        inner = self.inner
        tree = adamw_state_to_optax(int(inner.count), self._whole_states(), inner.factored,
                                    clipped=inner.max_grad_norm is not None)
        if inner.plateau is not None:
            tree = {"0": tree, "1": dict(inner.plateau_state)}
        return tree

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Take optax's whole tree and keep this rank's slices."""
        from ..convert import adamw_state_from_optax

        inner = self.inner
        if inner.plateau is not None:
            for key, value in state_dict["1"].items():
                inner.plateau_state[key].copy_(torch.as_tensor(value))
            state_dict = state_dict["0"]
        n = self.mesh.shape[DATA_AXIS]
        template = {}
        for (name, _), dim, loc in zip(self.params, self.dims, self.local):
            template[name] = {}
            for key, t in inner.state[loc].items():
                shape = list(t.shape)
                if dim is not None and t.ndim > dim:
                    shape[dim] *= n
                template[name][key] = t.new_empty(shape)
        count, loaded = adamw_state_from_optax(state_dict, template, inner.factored,
                                               clipped=inner.max_grad_norm is not None)
        inner.count.fill_(count)
        rank = self.mesh.data_rank
        for (name, _), dim, loc in zip(self.params, self.dims, self.local):
            state = inner.state[loc]
            for key, value in loaded[name].items():
                if dim is not None and state[key].ndim > dim:
                    chunk = value.shape[dim] // n
                    value = value.narrow(dim, rank * chunk, chunk)
                state[key].copy_(value)
