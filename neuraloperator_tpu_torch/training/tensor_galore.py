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

from ..convert import flatten_flax, unflatten_flax


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
    """

    def __init__(self, params, learning_rate, rank=0.25, update_proj_gap: int = 50,
                 galore_scale: float = 0.25, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 min_dim_size_to_project: int = 16, names: Optional[Sequence[str]] = None):
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
        self.steps = 0  # the host's copy of the count: the refresh is decided here
        self.count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        for p in params:
            st = self.state[p]
            if self.qualifies(p):
                ranks = _resolve_ranks(p.shape, rank)
                st["factors"] = [torch.zeros((s, r), dtype=p.dtype, device=p.device)
                                 for s, r in zip(p.shape, ranks)]
                st["m"] = torch.zeros(ranks, dtype=p.dtype, device=p.device)
                st["v"] = torch.zeros(ranks, dtype=p.dtype, device=p.device)
            else:
                st["factors"] = []
                st["m"] = torch.zeros_like(p)
                st["v"] = torch.zeros_like(p)

    def qualifies(self, p: torch.Tensor) -> bool:
        return p.ndim >= 2 and min(p.shape) >= self.min_dim_size_to_project

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
        for p in self.param_groups[0]["params"]:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            st = self.state[p]
            m, v = st["m"], st["v"]
            if not st["factors"]:
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g ** 2)
                u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p)
            else:
                if refresh:
                    for f, new in zip(st["factors"],
                                      _hosvd_factors(g, [f.shape[1] for f in st["factors"]])):
                        f.copy_(new)
                core = _project(g, st["factors"])
                m.copy_(b1 * m + (1 - b1) * core)
                v.copy_(b2 * v + (1 - b2) * core ** 2)
                core_upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                u = -lr * (self.galore_scale * _unproject(core_upd, st["factors"]) + wd * p)
            u = (u.float() * lr_scale).to(u.dtype)
            p.add_(u.to(p.dtype))

    def _named_states(self):
        if self.names is None:
            raise ValueError("this optimizer was made without parameter names; bind it with "
                             "named parameters to save or load its state")
        return dict(zip(self.names, (self.state[p] for p in self.param_groups[0]["params"])))

    def state_dict(self) -> dict:
        """The JAX ``GaLoreState`` tree: ``count`` and, per parameter,
        ``factors`` (``{"0": U_0, ...}``, empty for a plain leaf), ``m`` and
        ``v``. Its leaves are this optimizer's own tensors."""
        leaves = {}
        for name, st in self._named_states().items():
            leaves[name + ".m"] = st["m"]
            leaves[name + ".v"] = st["v"]
            for k, f in enumerate(st["factors"]):
                leaves[f"{name}.factors.{k}"] = f
        tree = {"count": self.count, "leaves": unflatten_flax(leaves)}
        for name, st in self._named_states().items():
            if not st["factors"]:
                node = tree["leaves"]
                for key in name.split("."):
                    node = node[key]
                node["factors"] = {}
        return tree

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        flat = flatten_flax(state_dict["leaves"])
        for name, st in self._named_states().items():
            for key in ("m", "v"):
                st[key].copy_(torch.as_tensor(flat[f"{name}.{key}"]))
            for k, f in enumerate(st["factors"]):
                f.copy_(torch.as_tensor(flat[f"{name}.factors.{k}"]))
        self.count.fill_(int(state_dict["count"]))
        self.steps = int(state_dict["count"])


class TensorGaLoreTransform:
    """What ``tensor_galore_adamw`` returns; the ``Trainer`` binds it to the
    model's named parameters."""

    def __init__(self, **settings):
        self.settings = settings

    def bind(self, params) -> TensorGaLoreAdamW:
        params = list(params)
        if params and isinstance(params[0], tuple):
            names, params = zip(*params)
            return TensorGaLoreAdamW(params, names=names, **self.settings)
        return TensorGaLoreAdamW(params, **self.settings)


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
