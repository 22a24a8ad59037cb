"""Checkpoint loading (port of ``neuraloperator_tpu/training/training_state.py``).

The JAX package saves a training state as ``{save_name}.msgpack`` (the
flax parameter tree, written by ``flax.serialization.to_bytes``) beside a
``manifest.json`` that records the epoch. This module reads it back into
the port's ``state_dict`` layout. Saving, and the optimizer's state, wait
for the port of checkpoint save/resume.
"""

import json
from pathlib import Path
from typing import Mapping, Optional

import torch

from .._common import not_ported
from ..convert import convert_flax_params
from ..serialization import read_msgpack


def load_training_state(
    save_dir,
    save_name: str,
    template: Mapping[str, torch.Tensor],
    opt_state_template=None,
    *,
    device="cuda",
):
    """Restore ``(state_dict, opt_state, epoch)`` saved by ``save_training_state``.

    ``template`` is the target model's ``state_dict()``; it may sit on the
    ``meta`` device. Every leaf is checked against it by name and shape and
    cast to its dtype (a checkpoint stored in float16 comes back in the
    template's float32), then placed on ``device``. ``opt_state`` is always
    None; ``epoch`` comes from ``manifest.json`` (None without one).
    """
    if opt_state_template is not None:
        raise not_ported("load_training_state opt_state_template", "checkpoint save/resume")
    save_dir = Path(save_dir)
    params = read_msgpack(save_dir / f"{save_name}.msgpack")
    state = convert_flax_params(params, template, device=device)
    return state, None, (read_manifest(save_dir) or {}).get("epoch")


def read_manifest(save_dir) -> Optional[dict]:
    """``manifest.json`` of a checkpoint directory, or None when there is none."""
    path = Path(save_dir) / "manifest.json"
    return json.loads(path.read_text()) if path.exists() else None
