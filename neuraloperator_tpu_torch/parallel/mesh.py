"""The data and model process groups (port of ``neuraloperator_tpu/parallel/mesh.py``).

The JAX package distributes inside one process over a ('data', 'model')
``jax.sharding.Mesh`` and lets XLA insert the collectives. ``torch.distributed``
runs one process per rank, so the port's :class:`Mesh` holds this rank's two
process groups and the collectives are written out where XLA inferred
them. The world is laid out as JAX's ``reshape(dp, mp)``: a model group is
``mp`` contiguous ranks, a data group the ``dp`` ranks ``mp`` apart.

* :func:`init_process_group` joins the world as ``torchrun`` sets it up
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
  or, without those variables, as a world of one on a local store; the
  backend is NCCL for the card and gloo for the CPU, and a failed NCCL
  init raises.
* :func:`shard_batch` keeps this data rank's slice of a global batch
  (a :class:`ShardedBatch`, which remembers the global size);
  :func:`replicate` broadcasts a module's state from rank 0.
* :func:`tp_param_specs` names, for each parameter, the dim the JAX
  package shards over 'model' (or None); :func:`shard_params` keeps only
  this model rank's slice of each such parameter as the ``nn.Parameter``,
  so the weight, its gradient and its optimizer state are split in memory
  over the model group, as JAX's arrays are. A non-separable spectral
  convolution whose out-channel factor is sliced (the dense ``w_weight``,
  the CP, Tucker and TT ``w_factor_1``) contracts its slice into this
  rank's out channels (``comm.copy_to_model_parallel_region`` before the
  contraction, ``comm.gather_from_model_parallel_region`` after it, and
  its other factors entered through ``copy_to``, so their gradients are
  summed over the group); any other module holding a sliced parameter
  (a separable or spherical convolution's weight, a scanned stack)
  gathers it for each call (``gather_from``: the whole weight forward,
  this rank's slice of its gradient backward).
* :func:`gather_state_dict` all-gathers a sharded model's slices to the
  whole ``state_dict`` (the JAX layout the files hold), and
  :func:`cut_state_dict` cuts a whole one to this rank's slices;
  :func:`whole_template` gives the whole shapes on the ``meta`` device.
"""

import os
from contextlib import contextmanager
from datetime import timedelta
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .._common import Device, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the collectives' timeout unless the caller gives one: a hung collective
# fails instead of waiting for torch's default of 10 minutes
DEFAULT_TIMEOUT = timedelta(seconds=300)

_CURRENT_MESH: Optional["Mesh"] = None


class Mesh:
    """This rank's place in the ('data', 'model') layout and its two groups.

    ``shape`` is ``{"data": dp, "model": mp}``; ``data_rank`` and
    ``model_rank`` are this rank's coordinates; ``data_group`` and
    ``model_group`` its process groups; ``device`` the device it computes on.
    """

    def __init__(self, model_parallel_size: int, device: torch.device, data_group,
                 model_group):
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        mp = model_parallel_size
        self.shape: Dict[str, int] = {DATA_AXIS: self.world_size // mp, MODEL_AXIS: mp}
        self.data_rank, self.model_rank = divmod(self.rank, mp)
        self.data_group, self.model_group = data_group, model_group
        self.device = device
        self._device_mesh = None

    def device_mesh(self):
        """The ('data', 'model') ``DeviceMesh`` over this mesh's two groups
        (``DeviceMesh.from_group``), made on the first call: the mesh the
        checkpoint's ``DTensor`` leaves are placed on."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            layout = torch.arange(self.world_size).reshape(self.shape[DATA_AXIS],
                                                           self.shape[MODEL_AXIS])
            self._device_mesh = DeviceMesh.from_group(
                [self.data_group, self.model_group], self.device.type, mesh=layout,
                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        return self._device_mesh

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, data_rank={self.data_rank}, "
                f"model_rank={self.model_rank}, device={self.device})")


def init_process_group(device: Device = "cuda") -> None:
    """Join the default process group, unless this process has already.

    With ``RANK`` and ``WORLD_SIZE`` in the environment (``torchrun``), the
    group is the one they describe (``env://``); without them, a world of
    one on a local store. The backend is NCCL for a CUDA ``device`` (on the
    card ``LOCAL_RANK`` names) and gloo for the CPU; nothing falls back from
    one to the other, so a failed NCCL init raises.
    """
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=DEFAULT_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=DEFAULT_TIMEOUT)


def init(model_parallel_size: int = 1, device: Device = "cuda") -> Mesh:
    """Split the world into model groups of ``model_parallel_size``
    contiguous ranks and data groups of the ranks between them; make the
    result the current mesh. Joins a world of one first when no process
    group exists (:func:`init_process_group`)."""
    global _CURRENT_MESH
    device = resolve_device(device)
    init_process_group(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if world % model_parallel_size:
        raise ValueError(f"world size {world} not divisible by "
                         f"model_parallel_size={model_parallel_size}")
    dp, mp = world // model_parallel_size, model_parallel_size
    rank = dist.get_rank()
    data_group = model_group = None
    # every rank makes every group, in the same order
    for d in range(dp):
        group = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = group
    for m in range(mp):
        group = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            data_group = group
    _CURRENT_MESH = Mesh(mp, device, data_group, model_group)
    return _CURRENT_MESH


def get_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


def get_data_parallel_size() -> int:
    return _CURRENT_MESH.shape[DATA_AXIS] if _CURRENT_MESH else 1


def get_model_parallel_size() -> int:
    return _CURRENT_MESH.shape[MODEL_AXIS] if _CURRENT_MESH else 1


@contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the current mesh inside the block."""
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


class ShardedBatch(dict):
    """A batch holding this data rank's slice; ``global_batch_size`` is the
    size of the batch it was cut from."""

    global_batch_size: int = 0


def local_slice(n: int, mesh: Mesh) -> slice:
    """This data rank's rows of a global batch of ``n``."""
    dp = mesh.shape[DATA_AXIS]
    if n % dp:
        raise ValueError(f"a batch of {n} does not split over {dp} data ranks")
    chunk = n // dp
    return slice(mesh.data_rank * chunk, (mesh.data_rank + 1) * chunk)


def shard_batch(batch: Mapping, mesh: Optional[Mesh] = None):
    """This data rank's slice (dim 0) of every entry of a global ``batch``,
    on the mesh's device; entries without a batch dim are kept whole. A
    :class:`ShardedBatch` is returned as it is; without a mesh, ``batch``."""
    mesh = mesh or _CURRENT_MESH
    if mesh is None or isinstance(batch, ShardedBatch):
        return batch
    out = ShardedBatch()
    n = None
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.ndim > 0:
            n = len(t) if n is None else n
            t = t[local_slice(len(t), mesh)]
        out[k] = t.to(mesh.device, non_blocking=True)
    out.global_batch_size = n or 0
    return out


def make_distributed_batch(batch: Mapping, mesh: Optional[Mesh] = None):
    """A batch of this process's own samples placed for the mesh: one
    process is one rank, so its local data is its data rank's slice as it
    is (the JAX function stitches per-host shards into a global array)."""
    mesh = mesh or _CURRENT_MESH
    if mesh is None or isinstance(batch, ShardedBatch):
        return batch
    if mesh.world_size == 1:
        return shard_batch(batch, mesh)
    out = ShardedBatch({k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()})
    sizes = [len(v) for v in out.values() if v.ndim > 0]
    out.global_batch_size = (sizes[0] if sizes else 0) * mesh.shape[DATA_AXIS]
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, overwritten in place;
    a model-sharded parameter (:func:`shard_params`) takes the slice of
    data rank 0 of its model rank."""
    mesh = mesh or _CURRENT_MESH
    if mesh is not None and mesh.world_size > 1:
        sharded = getattr(module, "model_parallel_params", {})
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if name in sharded:
                # data rank 0 of this model rank is global rank model_rank
                dist.broadcast(t.data, src=mesh.model_rank, group=mesh.data_group)
            else:
                dist.broadcast(t.data, src=0)
    return module


def _tp_spec_for_leaf(name: str, shape, siblings, msize: int) -> Optional[int]:
    """The dim of one spectral-weight parameter sharded over 'model', or None.

    Factorized weights keep the real and imaginary parts on a leading axis
    of 2; the out-channel dim depends on the factorization, told by the
    sibling parameters of the same module:

    * dense ``w_weight`` (2, in, out, modes...): dim 2
    * CP (``w_lambdas``) and Tucker (``w_core``) ``w_factor_1`` (2, out, rank): dim 1
    * TT (factors only) ``w_factor_1`` (2, r, out, r): dim 2

    each when it divides by the model size; anything else is replicated.
    """
    nd = len(shape)
    if name == "w_weight" and nd >= 4 and shape[2] % msize == 0:
        return 2
    if name == "w_factor_1":
        if "w_core" in siblings or "w_lambdas" in siblings:
            if nd == 3 and shape[1] % msize == 0:
                return 1
        elif nd == 4 and shape[2] % msize == 0:
            return 2
    return None


def tp_param_specs(params, mesh: Mesh) -> Dict[str, Optional[int]]:
    """``{name: dim or None}`` for each entry of ``params`` (a module, whose
    ``state_dict`` names are the JAX tree's dotted paths, or such a
    mapping): the dim the JAX package shards over 'model'. Only names
    starting with ``w_`` are spectral weights; each module's factorization
    is told from its own parameters' names."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    msize = mesh.shape[MODEL_AXIS]
    siblings: Dict[str, set] = {}
    for key in params:
        prefix, _, leaf = key.rpartition(".")
        siblings.setdefault(prefix, set()).add(leaf)
    specs = {}
    for key, value in params.items():
        prefix, _, leaf = key.rpartition(".")
        specs[key] = (_tp_spec_for_leaf(leaf, tuple(value.shape), siblings[prefix], msize)
                      if leaf.startswith("w_") else None)
    return specs


class ShardedParam(NamedTuple):
    """A parameter held as this model rank's slice: the sliced ``dim`` and
    the whole parameter's ``shape``."""

    dim: int
    shape: Tuple[int, ...]


def _out_channel_factor(module) -> Optional[Tuple[str, int]]:
    """``(name, dim)`` of the factor holding a non-separable spectral
    convolution's out channels, as it is stored (one layer, not a stack)."""
    from ..layers.spectral_convolution import SpectralConv
    from ..tensor.factorized import factor_shapes

    if not isinstance(module, SpectralConv) or module.separable:
        return None
    name, dim = ("weight", 2) if module.spec.kind == "dense" else (
        "factor_1", 2 if module.spec.kind == "tt" else 1)
    stored = getattr(module, f"w_{name}")
    if stored.ndim != 1 + len(factor_shapes(module.spec)[name]):
        return None
    return f"w_{name}", dim


def _gather_on_call(module: torch.nn.Module, dims: Dict[str, Tuple[int, int]], group) -> None:
    """Give ``module`` each sliced parameter of ``dims`` (``{name: (dim,
    ndim)}`` of the stored slice) whole for the length of each call: the
    gathered tensor shadows the parameter as an instance attribute. A call
    through ``torch.func.functional_call`` gathers the tensor it swapped in,
    its sliced dim counted from the end (a scanned stack's layers lose the
    leading axis)."""
    from . import comm

    def gather(mod, args):
        for name, (dim, ndim) in dims.items():
            t = mod._parameters[name]
            mod.__dict__[name] = comm.gather_from_model_parallel_region(
                t, dim - (ndim - t.ndim), group)

    def release(mod, args, out):
        for name in dims:
            mod.__dict__.pop(name, None)

    module.register_forward_pre_hook(gather)
    module.register_forward_hook(release, always_call=True)


def shard_params(model: torch.nn.Module, mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Keep only this model rank's slice of every parameter
    :func:`tp_param_specs` shards (see the module docstring). The sharded
    names are kept in ``model.model_parallel_params`` (``{name:
    ShardedParam(dim, whole shape)}``), the mesh in
    ``model.model_parallel_mesh`` (a ``comm.SharedGroup``). A dim that does
    not divide stays whole, as in JAX. Without a mesh, or at model size 1,
    the model is left as it is (an empty ``model_parallel_params``); a
    model already sharded is returned as it is."""
    from . import comm

    mesh = mesh or _CURRENT_MESH
    if getattr(model, "model_parallel_params", None):
        return model
    sharded: Dict[str, ShardedParam] = {}
    if mesh is not None and mesh.shape[MODEL_AXIS] > 1:
        group = mesh.model_group
        specs = tp_param_specs(model, mesh)
        for prefix, module in list(model.named_modules()):
            own = {}
            for leaf, p in list(module.named_parameters(recurse=False)):
                key = f"{prefix}.{leaf}" if prefix else leaf
                dim = specs.get(key)
                if dim is None:
                    continue
                sharded[key] = ShardedParam(dim, tuple(p.shape))
                own[leaf] = (dim, p.ndim)
                piece = comm.own_slice(p.detach(), dim, group)
                module._parameters[leaf] = torch.nn.Parameter(piece, p.requires_grad)
            if not own:
                continue
            out_factor = _out_channel_factor(module)
            if out_factor is not None and own == {out_factor[0]: (out_factor[1],
                                                                  own[out_factor[0]][1])}:
                module.model_group = comm.SharedGroup(group)
            else:
                _gather_on_call(module, own, group)
        model.model_parallel_mesh = comm.SharedGroup(mesh)
    model.model_parallel_params = sharded
    return model


def model_parallel_mesh(model) -> Optional[Mesh]:
    """The mesh a model was sharded over (:func:`shard_params`), or None."""
    held = getattr(model, "model_parallel_mesh", None)
    return None if held is None else held.group


def _sharding(model) -> Tuple[Dict[str, ShardedParam], object]:
    sharded = getattr(model, "model_parallel_params", None) or {}
    mesh = model_parallel_mesh(model)
    return sharded, (None if mesh is None else mesh.model_group)


def model_parallel_layout(model) -> Optional[Tuple[object, Dict[str, int]]]:
    """``(model group, {name: sliced dim})`` of a sharded model, else None:
    what an optimizer bound to its parameters needs to know."""
    sharded, group = _sharding(model)
    return (group, {n: s.dim for n, s in sharded.items()}) if sharded else None


def gather_state_dict(model: torch.nn.Module, state: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a sharded model: each slice all-gathered
    over the model group (every model rank must call it); the other entries
    as they are. ``state`` (default ``model.state_dict()``) holds the slices."""
    from . import comm

    state = model.state_dict() if state is None else state
    sharded, group = _sharding(model)
    return {k: (comm.all_gather_along(v, sharded[k].dim, group) if k in sharded else v)
            for k, v in state.items()}


def cut_state_dict(model: torch.nn.Module,
                   state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` cut to this model rank's slices of ``model``."""
    from . import comm

    sharded, group = _sharding(model)
    return {k: (comm.own_slice(v, sharded[k].dim, group) if k in sharded else v)
            for k, v in state.items()}


def whole_template(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` at the whole shapes, on the ``meta`` device:
    the template a file in the JAX layout is read against."""
    sharded, _ = _sharding(model)
    return {k: torch.empty(sharded[k].shape if k in sharded else v.shape, dtype=v.dtype,
                           device="meta")
            for k, v in model.state_dict().items()}


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "ShardedBatch", "ShardedParam", "cut_state_dict",
           "gather_state_dict", "get_data_parallel_size", "get_mesh",
           "get_model_parallel_size", "init", "init_process_group", "local_slice",
           "make_distributed_batch", "model_parallel_layout", "model_parallel_mesh",
           "replicate", "shard_batch", "shard_params", "tp_param_specs", "use_mesh",
           "whole_template"]
