"""Model registry, construction from checkpoint metadata, and checkpoint loading.

Port of the registry, ``get_model``, ``from_checkpoint`` and
``load_checkpoint`` of ``neuraloperator_tpu/models/base_model.py``. A
checkpoint's ``model_metadata.json`` (or ``{name}_metadata.json``) holds
``{"_name": ..., "_version": ..., "init_kwargs": {...}}``; the JSON
stand-ins ``{"__callable__": name}`` and ``{"__class__": name}`` are
resolved by name. ``load_flagship`` rebuilds a trained model, its data
processor and its manifest from a training run's directory.
"""

import inspect
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

from .._common import resolve_device
from ..convert import convert_flax_params
from ..data.transforms import load_data_processor
from ..serialization import read_msgpack
from ..training.training_state import load_training_state, read_manifest

_MODEL_REGISTRY: Dict[str, type] = {}
_VERSION = "0.1.0"


def register_model(cls=None, *, name: Optional[str] = None):
    """Register a model class under ``name`` (default: the class name)."""

    def wrap(c):
        _MODEL_REGISTRY[(name or c.__name__).lower()] = c
        return c

    return wrap(cls) if cls is not None else wrap


def available_models():
    return sorted(_MODEL_REGISTRY)


def get_model_class(arch: str) -> type:
    try:
        return _MODEL_REGISTRY[arch.lower()]
    except KeyError:
        raise ValueError(
            f"Got model_arch={arch!r}, expected one of {available_models()}"
        ) from None


def _named_objects() -> Dict[str, Dict[str, Any]]:
    from ..layers.channel_mlp import gelu
    from ..layers.spectral_convolution import SpectralConv

    return {
        "__callable__": {"gelu": gelu},
        "__class__": {"SpectralConv": SpectralConv},
    }


def _resolve(value):
    """Turn a JSON stand-in into the object it names; lists into tuples."""
    if isinstance(value, dict) and len(value) == 1:
        (tag, name), = value.items()
        table = _named_objects().get(tag)
        if table is not None:
            if name not in table:
                raise ValueError(f"no {tag} named {name!r}; known: {sorted(table)}")
            return table[name]
    if isinstance(value, list):
        return tuple(value)
    return value


def get_model(config: Mapping, *, device="cuda",
              generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Build a model from a config with ``model_arch`` and init kwargs.

    ``config`` is either the model dict itself or holds it under
    ``"model"``. Keys the model does not take are ignored with a warning.
    """
    model_cfg = dict(config.get("model", config))
    arch = model_cfg.pop("model_arch", None)
    if arch is None:
        raise ValueError("config.model must define 'model_arch'")
    cls = get_model_class(arch)
    accepted = set(inspect.signature(cls.__init__).parameters) - {
        "self", "device", "generator"
    }
    kwargs = {}
    for k, v in model_cfg.items():
        if k in accepted:
            kwargs[k] = _resolve(v)
        else:
            warnings.warn(f"get_model: ignoring config key {k!r} for {arch}")
    return cls(**kwargs, device=device, generator=generator)


def model_from_metadata(
    metadata: Union[Mapping, str, Path], *, device="cuda",
    generator: Optional[torch.Generator] = None,
) -> torch.nn.Module:
    """Build the model a ``model_metadata.json`` (path or parsed dict) describes."""
    if not isinstance(metadata, Mapping):
        metadata = json.loads(Path(metadata).read_text())
    config = {"model_arch": metadata["_name"], **metadata["init_kwargs"]}
    return get_model(config, device=device, generator=generator)


def from_checkpoint(save_folder, save_name: str, extra_kwargs: Optional[dict] = None, *,
                    device="cuda"):
    """The model ``{save_name}_metadata.json`` describes, with fresh weights.

    Load the weights with ``load_checkpoint`` (the ``save_checkpoint``
    layout) or ``training.load_training_state`` (the Trainer's).
    """
    meta = json.loads((Path(save_folder) / f"{save_name}_metadata.json").read_text())
    if meta.get("_version") != _VERSION:
        warnings.warn(
            f"Checkpoint saved with version {meta.get('_version')}, current "
            f"version is {_VERSION}. Proceeding, but parameters may mismatch."
        )
    if extra_kwargs:
        meta = {**meta, "init_kwargs": {**meta["init_kwargs"], **extra_kwargs}}
    return model_from_metadata(meta, device=device)


def load_checkpoint(module: torch.nn.Module, save_folder, save_name: str) -> torch.nn.Module:
    """Load ``{save_name}_state_dict.msgpack`` (``save_checkpoint``'s layout:
    the flax variables, parameters under ``"params"``) into ``module``.

    Leaves are checked by name and shape and cast to the module's dtypes.
    Returns ``module``.
    """
    variables = read_msgpack(Path(save_folder) / f"{save_name}_state_dict.msgpack")
    if not isinstance(variables, Mapping) or "params" not in variables:
        raise ValueError(f"{save_name}_state_dict.msgpack holds no 'params' tree")
    device = next(module.parameters()).device
    module.load_state_dict(
        convert_flax_params(variables["params"], module.state_dict(), device=device)
    )
    return module


def load_flagship(save_dir, save_name: str = "best_model", *, device="cuda"):
    """``(model, data_processor, manifest)`` of a training run's directory.

    Reads ``model_metadata.json`` (the architecture), ``data_processor.json``
    (the normalizers fitted on the training split; None without one),
    ``{save_name}.msgpack`` (the Trainer's parameter tree; a float16 copy
    comes back in float32) and ``manifest.json`` (``{}`` without one). The
    model is in eval mode on ``device``.
    """
    device = resolve_device(device)
    save_dir = Path(save_dir)
    model = model_from_metadata(save_dir / "model_metadata.json", device="meta")
    state, _, _ = load_training_state(save_dir, save_name, model.state_dict(), device=device)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval(), load_data_processor(save_dir), read_manifest(save_dir) or {}
