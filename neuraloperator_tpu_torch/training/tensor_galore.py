"""Tensor-GaLore: AdamW with Tucker projections of the gradients (port of
``neuraloperator_tpu/training/tensor_galore.py``).

The gradient of a large tensor (``ndim >= 2`` and every stored dim at least
``min_dim_size_to_project``; the spectral weights' leading real/imaginary
axis of 2 counts, as in the JAX package) is projected onto a low-rank Tucker
subspace whose factors come from a higher-order SVD of the gradient every
``update_proj_gap`` steps; the Adam moments live in the small core, and
the update is projected back and scaled by ``galore_scale``. Other tensors
take plain AdamW. The factors are the leading left singular vectors of the
mode unfoldings from ``torch.linalg.svd`` (LAPACK on the CPU, cuSOLVER on
the card; the JAX package leaves them to XLA's SVD).

Singular vectors are defined up to sign, and each library picks its own.
Between refreshes a flip cancels (the core, the first moment and the update
flip together, the second moment is a square), but a refresh keeps the
moments of the old factors, so a flip at a refresh changes the steps after
it. The port fixes the sign of every singular vector (its entry of largest
magnitude is positive), so where the kept singular values are distinct and
clear of zero the card and the CPU pick the same factors at every refresh;
it matches the JAX package, whose signs are XLA's, up to the second refresh,
and at every step when the JAX factors are sign-fixed the same way. Where a
rank keeps singular values that nearly vanish (a gradient of lower rank than
the rank kept), their vectors are rounding noise and each device picks its
own; Adam scales each core entry to a step of full size, so those
directions' updates differ between devices.

The refresh is a host decision (the step count is also kept on the host),
so the optimizer runs on the loader loop: a CUDA graph capture of its step
raises.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..convert import flatten_flax, unflatten_flax
from ..parallel import comm


def _unfold(t: torch.Tensor, mode: int) -> torch.Tensor:
    return torch.movedim(t, mode, 0).reshape(t.shape[mode], -1)


def _fix_signs(u: torch.Tensor) -> torch.Tensor:
    """Each column of ``u`` times the sign of its entry of largest magnitude."""
    idx = u.abs().argmax(dim=0, keepdim=True)
    sign = torch.sign(torch.gather(u, 0, idx))
    return u * torch.where(sign == 0, torch.ones_like(sign), sign)


def _hosvd_factors(g: torch.Tensor, ranks: Sequence[int]):
    """The leading ``ranks[k]`` left singular vectors of each mode unfolding
    (the identity where the rank covers the dim), signs fixed."""
    factors = []
    for mode, r in enumerate(ranks):
        if r >= g.shape[mode]:
            factors.append(torch.eye(g.shape[mode], dtype=g.dtype, device=g.device))
            continue
        u, _, _ = torch.linalg.svd(_unfold(g, mode), full_matrices=False)
        factors.append(_fix_signs(u[:, :r]))
    return factors


def _project(g: torch.Tensor, factors) -> torch.Tensor:
    """core = g x_k U_k^T."""
    core = g
    for mode, u in enumerate(factors):
        core = torch.movedim(
            torch.tensordot(u.T, torch.movedim(core, mode, 0), dims=([1], [0])), 0, mode)
    return core


def _unproject(core: torch.Tensor, factors) -> torch.Tensor:
    g = core
    for mode, u in enumerate(factors):
        g = torch.movedim(torch.tensordot(u, torch.movedim(g, mode, 0), dims=([1], [0])), 0, mode)
    return g


def _zero_dim(shape, n: int, skip: Optional[int] = None) -> Optional[int]:
    """The dim a state tensor of ``shape`` is cut along over ``n`` data ranks."""
    from ..parallel.zero import _leaf_spec

    return None if n == 1 else _leaf_spec(tuple(shape), n, skip)


def _cut_shape(shape, dim: Optional[int], n: int) -> Tuple[int, ...]:
    return tuple(s // n if d == dim else s for d, s in enumerate(shape))


def _resolve_ranks(shape, rank) -> Tuple[int, ...]:
    if isinstance(rank, (list, tuple)):
        return tuple(int(r) for r in rank)
    if isinstance(rank, float) and rank <= 1.0:
        return tuple(max(1, int(round(rank * s))) for s in shape)
    return tuple(min(int(rank), s) for s in shape)


class TensorGaLoreAdamW(torch.optim.Optimizer):
    """AdamW with Tucker-projected moments for the tensors that qualify.

    ``step(lr_scale=...)`` applies one update from the parameters' ``.grad``
    (a missing gradient counts as zero), scaled by the ``Trainer``'s
    per-epoch factor in f32. The rate is ``learning_rate(count)`` after the
    count's increment, as the JAX transformation reads it.

    ``model_parallel`` (``(group, {name: dim})``, what
    ``parallel.mesh.model_parallel_layout`` gives; needs ``names``): those
    parameters are held as slices of ``dim`` over ``group``. Whether a leaf
    qualifies, and its ranks, follow the whole leaf's shape. A sliced leaf's
    factors are the whole leaf's HOSVD: at a refresh its gradient is
    all-gathered over the group and every rank keeps model rank 0's
    factors. Each step a rank projects its slice with its rows of the sliced
    mode's factor and the partial cores are summed over the group, so the
    core, its moments and the factors are replicated over the model group
    (the core has prod(ranks) entries, far fewer than a slice); the rank
    then unprojects with its rows, to its slice of the update. A sliced
    leaf that does not qualify keeps its moments as slices.

    ``zero_group`` (ZeRO-1: the mesh's data group, as
    ``parallel.zero.bind_zero`` passes it): every state tensor is cut over
    the data ranks along the JAX package's zero dim (``zero._leaf_spec``:
    its largest dim that divides by the group's size). A plain leaf's slice
    of the parameter is updated from its slice of the reduced gradient and
    the parameter all-gathered, as ``ZeroAdamW`` does (never along a model
    slice's dim); a projected leaf's factors are all-gathered for the step,
    its whole core projected, its moments updated on their slices and the
    core's update all-gathered before every rank unprojects it. At a
    refresh every rank keeps data rank 0's factors. The arithmetic is the
    replicated optimizer's, and so are the numbers.

    ``state_dict`` gathers the state to the whole JAX ``GaLoreState`` tree
    and ``load_state_dict`` cuts it, at any model or data size.
    """

    def __init__(self, params, learning_rate, rank=0.25, update_proj_gap: int = 50,
                 galore_scale: float = 0.25, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 min_dim_size_to_project: int = 16, names: Optional[Sequence[str]] = None,
                 model_parallel=None, zero_group=None):
        params = list(params)
        super().__init__(params, {})
        self.learning_rate = learning_rate
        self.rank = rank
        self.update_proj_gap = update_proj_gap
        self.galore_scale = galore_scale
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.min_dim_size_to_project = min_dim_size_to_project
        self.names = None if names is None else list(names)
        self.model_group, self.model_dims = None, {}
        if model_parallel is not None:
            if names is None:
                raise ValueError("a model-parallel Tensor-GaLore needs the parameters' names")
            self.model_group, dims = model_parallel
            self.model_dims = {p: dims[n] for n, p in zip(names, params) if n in dims}
        n = 1 if zero_group is None else dist.get_world_size(zero_group)
        self.zero_group = zero_group if n > 1 else None
        self.steps = 0  # the host's copy of the count: the refresh is decided here
        self.count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        for p in params:
            st = self.state[p]
            if self.qualifies(p):
                whole = self.whole_shape(p)
                ranks = _resolve_ranks(whole, rank)
                shapes = list(zip(whole, ranks))
                # replicated over the model group: any dim may be cut
                st["cut"] = {"m": _zero_dim(ranks, n),
                             "factors": [_zero_dim(s, n) for s in shapes]}
                st["factors"] = [torch.zeros(_cut_shape(s, d, n), dtype=p.dtype, device=p.device)
                                 for s, d in zip(shapes, st["cut"]["factors"])]
            else:
                ranks = tuple(p.shape)
                st["cut"] = {"m": _zero_dim(ranks, n, self.model_dims.get(p)), "factors": []}
                st["factors"] = []
            st["m"] = torch.zeros(_cut_shape(ranks, st["cut"]["m"], n), dtype=p.dtype,
                                  device=p.device)
            st["v"] = torch.zeros_like(st["m"])

    def whole_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        """The shape of the whole leaf that ``p`` is (or is a model slice of)."""
        shape = list(p.shape)
        if p in self.model_dims:
            shape[self.model_dims[p]] *= dist.get_world_size(self.model_group)
        return tuple(shape)

    def qualifies(self, p: torch.Tensor) -> bool:
        shape = self.whole_shape(p)
        return len(shape) >= 2 and min(shape) >= self.min_dim_size_to_project

    # -- the cuts
    def _own(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This data rank's slice of ``t`` along ``dim`` (a view), or ``t``."""
        if dim is None:
            return t
        chunk = t.shape[dim] // dist.get_world_size(self.zero_group)
        return t.narrow(dim, dist.get_rank(self.zero_group) * chunk, chunk)

    def _whole(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        return t if dim is None else comm.all_gather_along(t, dim, self.zero_group)

    def _model_rows(self, p: torch.Tensor, factors) -> list:
        """``factors`` with the sliced mode's cut to this model rank's rows."""
        factors = list(factors)
        dim = self.model_dims.get(p)
        if dim is not None:
            rows = p.shape[dim]
            factors[dim] = factors[dim].narrow(0, dist.get_rank(self.model_group) * rows, rows)
        return factors

    def _factors(self, p: torch.Tensor, g: torch.Tensor, refresh: bool) -> list:
        """The whole factors of ``p`` for this step; when ``refresh``, the
        HOSVD of the whole gradient, the same on every rank."""
        st = self.state[p]
        cuts = st["cut"]["factors"]
        if not refresh:
            return [self._whole(f, d) for f, d in zip(st["factors"], cuts)]
        dim = self.model_dims.get(p)
        whole = g if dim is None else comm.all_gather_along(g, dim, self.model_group)
        n = 1 if self.zero_group is None else dist.get_world_size(self.zero_group)
        ranks = [f.shape[1] * (n if d == 1 else 1) for f, d in zip(st["factors"], cuts)]
        factors = _hosvd_factors(whole, ranks)
        for group in (None if dim is None else self.model_group, self.zero_group):
            if group is not None:
                for f in factors:
                    dist.broadcast(f, dist.get_global_rank(group, 0), group=group)
        for f, new, d in zip(st["factors"], factors, cuts):
            f.copy_(self._own(new, d))
        return factors

    @torch.no_grad()
    def step(self, lr_scale: float = 1.0) -> None:
        if self.count.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("Tensor-GaLore's projection refresh is decided on the host; "
                               "train it on the loader loop (device_dataset false)")
        self.steps += 1
        self.count.add_(1)
        count = self.count.float()
        lr = self.learning_rate(self.count) if callable(self.learning_rate) \
            else self.learning_rate
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        bc1, bc2 = 1 - torch.pow(b1, count), 1 - torch.pow(b2, count)
        refresh = (self.steps - 1) % self.update_proj_gap == 0
        cut_params = []
        for p in self.param_groups[0]["params"]:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            st = self.state[p]
            m, v, d = st["m"], st["v"], st["cut"]["m"]
            if not st["factors"]:
                g, held = self._own(g, d), self._own(p.detach(), d)
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g ** 2)
                u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * held)
                if d is not None:
                    cut_params.append((p, held, d))
            else:
                held = p.detach()
                factors = self._model_rows(p, self._factors(p, g, refresh))
                core = _project(g, factors)
                if p in self.model_dims:  # the slices' partial cores
                    dist.all_reduce(core, group=self.model_group)
                core = self._own(core, d)
                m.copy_(b1 * m + (1 - b1) * core)
                v.copy_(b2 * v + (1 - b2) * core ** 2)
                core_upd = self._whole((m / bc1) / (torch.sqrt(v / bc2) + eps), d)
                u = -lr * (self.galore_scale * _unproject(core_upd, factors) + wd * held)
            u = (u.float() * lr_scale).to(u.dtype)
            held.add_(u.to(p.dtype))
        for p, held, d in cut_params:
            comm.all_gather_into(p.detach(), held, d, self.zero_group)

    def _named_params(self) -> dict:
        if self.names is None:
            raise ValueError("this optimizer was made without parameter names; bind it with "
                             "named parameters to save or load its state")
        return dict(zip(self.names, self.param_groups[0]["params"]))

    def state_dict(self) -> dict:
        """The JAX ``GaLoreState`` tree: ``count`` and, per parameter,
        ``factors`` (``{"0": U_0, ...}``, empty for a plain leaf), ``m`` and
        ``v``, each whole (every rank joins the gathers). Its leaves are this
        optimizer's own tensors where nothing is cut."""
        leaves, plain = {}, []
        for name, p in self._named_params().items():
            st = self.state[p]
            for key in ("m", "v"):
                t = self._whole(st[key], st["cut"]["m"])
                if not st["factors"] and p in self.model_dims:
                    t = comm.all_gather_along(t, self.model_dims[p], self.model_group)
                leaves[f"{name}.{key}"] = t
            for k, (f, d) in enumerate(zip(st["factors"], st["cut"]["factors"])):
                leaves[f"{name}.factors.{k}"] = self._whole(f, d)
            if not st["factors"]:
                plain.append(name)
        tree = {"count": self.count, "leaves": unflatten_flax(leaves)}
        for name in plain:
            node = tree["leaves"]
            for key in name.split("."):
                node = node[key]
            node["factors"] = {}
        return tree

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Copy a whole ``GaLoreState`` tree in, keeping this rank's cuts."""
        flat = flatten_flax(state_dict["leaves"])
        for name, p in self._named_params().items():
            st = self.state[p]
            for key in ("m", "v"):
                value = torch.as_tensor(flat[f"{name}.{key}"]).to(p.device)
                if not st["factors"] and p in self.model_dims:
                    value = comm.own_slice(value, self.model_dims[p], self.model_group)
                st[key].copy_(self._own(value, st["cut"]["m"]))
            for k, (f, d) in enumerate(zip(st["factors"], st["cut"]["factors"])):
                f.copy_(self._own(torch.as_tensor(flat[f"{name}.factors.{k}"]).to(p.device), d))
        self.count.fill_(int(state_dict["count"]))
        self.steps = int(state_dict["count"])


class TensorGaLoreTransform:
    """What ``tensor_galore_adamw`` returns; the ``Trainer`` binds it to the
    model's named parameters."""

    def __init__(self, **settings):
        self.settings = settings

    def bind(self, params, model_parallel=None, zero_group=None) -> TensorGaLoreAdamW:
        """``params``: tensors, or ``(name, tensor)`` pairs (needed to save
        and load the state, and by ``model_parallel``); ``model_parallel``
        and ``zero_group`` as :class:`TensorGaLoreAdamW` takes them."""
        params = list(params)
        names = None
        if params and isinstance(params[0], tuple):
            names, params = zip(*params)
        return TensorGaLoreAdamW(params, names=names, model_parallel=model_parallel,
                                 zero_group=zero_group, **self.settings)


def tensor_galore_adamw(
    learning_rate,
    rank=0.25,
    update_proj_gap: int = 50,
    galore_scale: float = 0.25,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    min_dim_size_to_project: int = 16,
) -> TensorGaLoreTransform:
    """AdamW with Tucker gradient projection for the tensors that qualify
    (``ndim >= 2`` and every dim at least ``min_dim_size_to_project``)."""
    return TensorGaLoreTransform(
        learning_rate=learning_rate, rank=rank, update_proj_gap=update_proj_gap,
        galore_scale=galore_scale, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        min_dim_size_to_project=min_dim_size_to_project)


class TensorGaLoreProjector:
    """A stateful Tucker projector of one gradient: ``project`` refreshes the
    factors every ``update_proj_gap`` calls (or at ``iter_``'s multiples) and
    returns the core; ``project_back`` maps a core back, times ``scale``."""

    def __init__(self, rank, update_proj_gap: int = 200, scale: float = 1.0):
        self.rank = rank
        self.update_proj_gap = update_proj_gap
        self.scale = scale
        self.factors = None
        self._step = 0

    def project(self, grad: torch.Tensor, iter_: Optional[int] = None) -> torch.Tensor:
        step = self._step if iter_ is None else iter_
        if self.factors is None or step % self.update_proj_gap == 0:
            self.factors = _hosvd_factors(grad, _resolve_ranks(grad.shape, self.rank))
        self._step = step + 1
        return _project(grad, self.factors)

    def project_back(self, core: torch.Tensor) -> torch.Tensor:
        if self.factors is None:
            raise RuntimeError("project() must run first")
        return _unproject(core, self.factors) * self.scale


__all__ = ["TensorGaLoreAdamW", "TensorGaLoreProjector", "tensor_galore_adamw"]
