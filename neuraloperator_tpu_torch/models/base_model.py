"""Model registry and construction from checkpoint metadata.

Port of the registry and ``get_model`` of
``neuraloperator_tpu/models/base_model.py``. A checkpoint's
``model_metadata.json`` holds ``{"_name": ..., "init_kwargs": {...}}``; the
JSON stand-ins ``{"__callable__": name}`` and ``{"__class__": name}`` are
resolved by name.
"""

import inspect
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

_MODEL_REGISTRY: Dict[str, type] = {}


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
