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
"""

import json
from pathlib import Path
from typing import Any, Mapping, Optional

import torch

from ..convert import as_tensor, convert_flax_params, to_flax_params
from ..serialization import read_msgpack, write_msgpack


def save_training_state(
    save_dir,
    save_name: str,
    params: Mapping[str, torch.Tensor],
    opt_state: Optional[Mapping] = None,
    epoch: Optional[int] = None,
    best_params: Optional[Mapping[str, torch.Tensor]] = None,
    extra_manifest: Optional[dict] = None,
    data_processor=None,
) -> Path:
    """Write ``{save_name}.msgpack`` (+ ``optimizer.msgpack``, ``manifest.json``).

    ``params`` (and ``best_params``) are port ``state_dict``s; ``opt_state``
    is an optax state tree (``AdamW.state_dict()``). A ``data_processor``
    with ``state_dict()`` is written as ``data_processor.json``.
    """
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
    template: Mapping[str, torch.Tensor],
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
    ``manifest.json`` (None without one).
    """
    save_dir = Path(save_dir)
    params = read_msgpack(save_dir / f"{save_name}.msgpack")
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


__all__ = ["load_training_state", "read_manifest", "save_training_state"]
