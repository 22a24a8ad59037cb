"""Training-state persistence (port of ``neuraloperator_tpu/training/training_state.py``).

A training state in a directory, in the JAX package's format, so either
package resumes the other's run:

- ``{save_name}.msgpack``: the flax parameter tree, as
  ``flax.serialization.to_bytes`` writes it (``serialization.write_msgpack``
  of ``convert.to_flax_params``);
- ``optimizer.msgpack``: optax's state tree (``AdamW.state_dict()``);
- ``manifest.json``: the epoch and the best metric, merged with what the
  file already holds, so a best-model save never clobbers the resume epoch
  of the periodic save, and back;
- ``data_processor.json``: the fitted normalizers, when a data processor is
  given.

A model-sharded model (``parallel.mesh.shard_params``) given in place of a
``state_dict`` is gathered to the whole tree, which rank 0 alone writes,
and read back as this rank's slices.

The JAX package's sharding-aware, optionally asynchronous checkpoint
(``save_training_state_orbax``, ``load_training_state_orbax``) is written
here over ``torch.distributed.checkpoint`` (DCP) into the same
``save_dir/orbax`` directory: each rank writes its own slices, with no
gather, as ``DTensor`` leaves of the mesh's ('data', 'model')
``DeviceMesh``, so the files record the whole shapes and a load at another
model size, or in a world of one, reshards. DCP's files are not orbax's:
neither package reads the other's (the msgpack files stay the format the
two exchange).
"""

import json
import shutil
from pathlib import Path
from typing import Any, Mapping, Optional, Union

import torch
import torch.distributed as dist

from ..convert import as_tensor, convert_flax_params, to_flax_params
from ..parallel import mesh as mesh_lib
from ..serialization import read_msgpack, write_msgpack


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save_training_state(
    save_dir,
    save_name: str,
    params: Union[Mapping[str, torch.Tensor], torch.nn.Module],
    opt_state: Optional[Mapping] = None,
    epoch: Optional[int] = None,
    best_params: Optional[Mapping[str, torch.Tensor]] = None,
    extra_manifest: Optional[dict] = None,
    data_processor=None,
) -> Path:
    """Write ``{save_name}.msgpack`` (+ ``optimizer.msgpack``, ``manifest.json``).

    ``params`` (and ``best_params``) are port ``state_dict``s; ``opt_state``
    is an optax state tree (``AdamW.state_dict()``). A ``data_processor``
    with ``state_dict()`` is written as ``data_processor.json``. ``params``
    may be the model itself: a model-sharded one is gathered to the whole
    tree; every rank must call, rank 0 alone writes, and the files are
    written when any rank's call returns.
    """
    if isinstance(params, torch.nn.Module):
        state = mesh_lib.gather_state_dict(params)
        if _rank() == 0:
            save_training_state(save_dir, save_name, state, opt_state, epoch, best_params,
                                extra_manifest, data_processor)
        if dist.is_initialized():
            dist.barrier()
        return Path(save_dir)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if data_processor is not None and hasattr(data_processor, "state_dict"):
        try:
            (save_dir / "data_processor.json").write_text(
                json.dumps(data_processor.state_dict()))
        except (TypeError, ValueError):
            pass  # a processor state JSON cannot hold: the weights are still saved
    write_msgpack(save_dir / f"{save_name}.msgpack", to_flax_params(params))
    if best_params is not None:
        write_msgpack(save_dir / "best_model.msgpack", to_flax_params(best_params))
    if opt_state is not None:
        write_msgpack(save_dir / "optimizer.msgpack", opt_state)
    manifest = read_manifest(save_dir, tolerate_damage=True) or {}
    if epoch is not None:
        manifest["epoch"] = epoch
    if extra_manifest:
        manifest.update(extra_manifest)
    (save_dir / "manifest.json").write_text(json.dumps(manifest))
    return save_dir


def load_training_state(
    save_dir,
    save_name: str,
    template: Union[Mapping[str, torch.Tensor], torch.nn.Module],
    opt_state_template: Optional[Mapping] = None,
    *,
    device="cuda",
):
    """Restore ``(state_dict, opt_state, epoch)`` saved by ``save_training_state``.

    ``template`` is the target model's ``state_dict()``; it may sit on the
    ``meta`` device. Every leaf is checked against it by name and shape and
    cast to its dtype (a checkpoint stored in float16 comes back in the
    template's float32), then placed on ``device``. With
    ``opt_state_template`` (the target optimizer's ``state_dict()``) and an
    ``optimizer.msgpack`` in the directory, ``opt_state`` is that file's
    tree, checked against the template by name and shape, its leaves in the
    template's dtypes on its devices; otherwise None. ``epoch`` comes from
    ``manifest.json`` (None without one). ``template`` may be the model
    itself: the file is read at its whole shapes and, for a model-sharded
    model, cut to this rank's slices.
    """
    save_dir = Path(save_dir)
    params = read_msgpack(save_dir / f"{save_name}.msgpack")
    if isinstance(template, torch.nn.Module):
        model = template
        state = mesh_lib.cut_state_dict(
            model, convert_flax_params(params, mesh_lib.whole_template(model), device=device))
    else:
        state = convert_flax_params(params, template, device=device)
    opt_state = None
    opt_path = save_dir / "optimizer.msgpack"
    if opt_state_template is not None and opt_path.exists():
        opt_state = _restore_like(opt_state_template, read_msgpack(opt_path), "optimizer")
    return state, opt_state, (read_manifest(save_dir) or {}).get("epoch")


def _restore_like(template: Any, tree: Any, path: str) -> Any:
    """``tree`` with the structure of ``template`` checked, map by map and leaf
    by leaf (shape), and each leaf cast to the template leaf's dtype and device."""
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"{path}: keys {got} do not match the template's "
                             f"{sorted(template)}")
        return {k: _restore_like(template[k], tree[k], f"{path}.{k}") for k in template}
    if tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"{path}: shape {tuple(tree.shape)} != the template's "
                         f"{tuple(template.shape)}")
    leaf, template = as_tensor(tree), as_tensor(template)
    return leaf.to(device=template.device, dtype=template.dtype)


def read_manifest(save_dir, tolerate_damage: bool = False) -> Optional[dict]:
    """``manifest.json`` of a checkpoint directory, or None when there is none
    (or, with ``tolerate_damage``, when it cannot be read as JSON, which the
    JAX package's save treats as empty)."""
    path = Path(save_dir) / "manifest.json"
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        if tolerate_damage:
            return None
        raise


# --------------------------------------------------------- the sharded checkpoint

ORBAX_DIR = "orbax"


def _placed(t: torch.Tensor, data_dim, model_dim, device_mesh):
    """``t`` as a ``DTensor`` sharded along the dims it is a slice of (over
    the mesh's 'data' and 'model' dims), or as it is when it is whole."""
    if data_dim is None and model_dim is None:
        return t
    if device_mesh is None:
        raise ValueError("a sliced optimizer state needs its mesh: give the sharded model "
                         "as params")
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate() if d is None else Shard(d) for d in (data_dim, model_dim)]
    return DTensor.from_local(t, device_mesh, placements, run_check=False)


def _params_tree(params) -> dict:
    """The checkpoint's ``params``: a module's own tensors, each model slice
    placed on the mesh; a ``state_dict`` as it is."""
    if not isinstance(params, torch.nn.Module):
        return {k: as_tensor(v) for k, v in params.items()}
    state = params.state_dict()
    sharded = getattr(params, "model_parallel_params", None) or {}
    if not sharded:
        return state
    device_mesh = mesh_lib.model_parallel_mesh(params).device_mesh()
    return {k: _placed(v, None, sharded[k].dim, device_mesh) if k in sharded else v
            for k, v in state.items()}


def _opt_tree(opt_state, params) -> dict:
    """The checkpoint's ``opt_state``: a bound optimizer's own state
    (``cut_state``), each slice placed on the mesh; an optax tree with its
    leaves as tensors."""
    if hasattr(opt_state, "cut_state"):
        cut = opt_state.cut_state()
        mesh = getattr(opt_state, "mesh", None) or (
            mesh_lib.model_parallel_mesh(params) if isinstance(params, torch.nn.Module)
            else None)
        device_mesh = None if mesh is None or mesh.world_size == 1 else mesh.device_mesh()
        tree = {k: v for k, v in cut.items() if k != "state"}
        tree["state"] = {name: {k: _placed(t, dd, md, device_mesh)
                                for k, (t, dd, md) in leaves.items()}
                         for name, leaves in cut["state"].items()}
        return tree

    def leaves(node):
        if isinstance(node, Mapping):
            return {k: leaves(v) for k, v in node.items()}
        return as_tensor(node)

    return leaves(opt_state)


def save_training_state_orbax(save_dir, params, opt_state=None, epoch: Optional[int] = None,
                              async_save: bool = False) -> Path:
    """Write a sharded checkpoint into ``save_dir/orbax`` (replacing one
    there) and return that path: the JAX function's signature and layout,
    over ``torch.distributed.checkpoint`` (see the module docstring).

    ``params``: the model (a model-sharded one writes each rank's slices)
    or a ``state_dict``; ``opt_state``: the bound optimizer (``AdamW`` or
    ``ZeroAdamW``, its state cut as it is held) or an optax state tree;
    ``epoch`` an int. Every rank of the world must call it. With
    ``async_save`` the files are written by ``dcp.async_save`` (its staging
    copy on the host, the writing in a thread), and the call waits for it
    before returning, as the JAX function waits; DCP's asynchronous save
    needs a process group with a CPU backend (gloo).
    """
    import torch.distributed.checkpoint as dcp

    distributed = dist.is_initialized()
    path = Path(save_dir).absolute() / ORBAX_DIR
    if _rank() == 0 and path.exists():
        shutil.rmtree(path)
    if distributed:
        dist.barrier()
    path.mkdir(parents=True, exist_ok=True)
    state = {"params": _params_tree(params)}
    if opt_state is not None:
        state["opt_state"] = _opt_tree(opt_state, params)
    if epoch is not None:
        state["epoch"] = torch.tensor(int(epoch), dtype=torch.int64)
    if async_save:
        pending = dcp.async_save(state, checkpoint_id=str(path), no_dist=not distributed)
        # a Future, or a response whose upload_completion is the last step
        getattr(pending, "upload_completion", pending).result()
    else:
        dcp.save(state, checkpoint_id=str(path), no_dist=not distributed)
    return path


def load_training_state_orbax(save_dir, params_template, opt_state_template=None):
    """Restore ``(params, opt_state, epoch)`` saved by
    :func:`save_training_state_orbax`; ``save_dir`` is the directory or its
    ``orbax`` child, as in JAX.

    ``params_template``: the model (restored in place, a model-sharded one
    reading its slices; ``params`` is then its ``state_dict()``) or a
    ``state_dict`` (read into new tensors of its shapes, dtypes and
    devices). ``opt_state_template``: the bound optimizer (restored in
    place and returned) or an optax tree (read into new tensors). The files
    are resharded to the template's layout: a save at one model size loads
    at another, or in a world of one. ``opt_state`` is None when the save
    holds none or no template is given; ``epoch`` None when it holds none.
    Every rank of the world must call it.
    """
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    path = Path(save_dir).absolute()
    if path.name != ORBAX_DIR:
        path = path / ORBAX_DIR
    saved = FileSystemReader(str(path)).read_metadata().state_dict_metadata
    in_place = isinstance(params_template, torch.nn.Module)
    state = {"params": (_params_tree(params_template) if in_place else
                        {k: torch.empty_like(as_tensor(v)) for k, v in params_template.items()})}
    has_opt = opt_state_template is not None and any(k.startswith("opt_state.") for k in saved)
    if has_opt:
        tree = _opt_tree(opt_state_template, params_template)
        state["opt_state"] = (tree if hasattr(opt_state_template, "cut_state")
                              else _empty_like_tree(tree))
    if "epoch" in saved:
        state["epoch"] = torch.zeros((), dtype=torch.int64)
    dcp.load(state, checkpoint_id=str(path), no_dist=not dist.is_initialized())
    params = params_template.state_dict() if in_place else state["params"]
    opt_state = None
    if has_opt:
        opt_state = (opt_state_template if hasattr(opt_state_template, "cut_state")
                     else state["opt_state"])
    epoch = int(state["epoch"]) if "epoch" in state else None
    return params, opt_state, epoch


def _empty_like_tree(node):
    if isinstance(node, Mapping):
        return {k: _empty_like_tree(v) for k, v in node.items()}
    return torch.empty_like(node)


__all__ = ["load_training_state", "load_training_state_orbax", "read_manifest",
           "save_training_state", "save_training_state_orbax"]
