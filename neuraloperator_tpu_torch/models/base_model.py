"""Model registry, construction from checkpoint metadata, and checkpoint loading.

Port of the registry, ``get_model``, ``from_checkpoint`` and
``load_checkpoint`` of ``neuraloperator_tpu/models/base_model.py``. A
checkpoint's ``model_metadata.json`` (or ``{name}_metadata.json``) holds
``{"_name": ..., "_version": ..., "init_kwargs": {...}}``; the JSON
stand-ins ``{"__callable__": name}`` and ``{"__class__": name}`` are
resolved by name. A registered model records the arguments it was built
with, and ``save_arch_metadata`` writes them in that layout, which this
module's ``from_checkpoint`` and the JAX package's both read;
``save_checkpoint`` writes them beside the weights.
``load_flagship`` rebuilds a trained model, its data processor and its
manifest from a training run's directory.
"""

import functools
import inspect
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import torch

from .._common import resolve_device
from ..convert import convert_flax_params, to_flax_params
from ..data.transforms import load_data_processor
from ..serialization import read_msgpack, write_msgpack
from ..training.training_state import load_training_state, read_manifest

_MODEL_REGISTRY: Dict[str, type] = {}
_VERSION = "0.1.0"


_NOT_ARCHITECTURE = ("self", "device", "generator")


def register_model(cls=None, *, name: Optional[str] = None):
    """Register a model class under ``name`` (default: the class name).

    Its instances keep the arguments they were built with, defaults
    applied, in ``_init_kwargs`` (``device`` and ``generator`` left out):
    what ``save_arch_metadata`` writes.
    """

    def wrap(c):
        init = c.__init__
        signature = inspect.signature(init)

        @functools.wraps(init)
        def recording_init(self, *args, **kwargs):
            init(self, *args, **kwargs)
            bound = signature.bind(self, *args, **kwargs)
            bound.apply_defaults()
            self._init_kwargs = {k: v for k, v in bound.arguments.items()
                                 if k not in _NOT_ARCHITECTURE}

        c.__init__ = recording_init
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
    from ..layers.spherical_convolution import SphericalConv

    return {
        "__callable__": {"gelu": gelu},
        "__class__": {"SpectralConv": SpectralConv, "SphericalConv": SphericalConv},
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


def get_model(config, *, device="cuda",
              generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Build a model from a config with ``model_arch`` and init kwargs.

    ``config`` (a dict or a config with ``to_dict()``) is either the model
    dict itself or holds it under ``"model"``. ``data_channels`` becomes
    ``in_channels``, multiplied by ``patching.levels + 1`` when the config
    has a patching section, as in the JAX package. Keys the model does not
    take are ignored with a warning.
    """
    if hasattr(config, "to_dict"):
        config = config.to_dict()
    model_cfg = dict(config.get("model", config))
    arch = model_cfg.pop("model_arch", None) or model_cfg.pop("arch", None)
    if arch is None:
        raise ValueError("config.model must define 'model_arch'")
    cls = get_model_class(arch)
    data_channels = model_cfg.pop("data_channels", None)
    if data_channels is not None:
        levels = config.get("patching", {}).get("levels", 0) if "patching" in config else 0
        model_cfg["in_channels"] = data_channels * (levels + 1) if levels else data_channels
    accepted = set(inspect.signature(cls.__init__).parameters) - set(_NOT_ARCHITECTURE)
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


def _json_value(value):
    """An init argument as the JAX package's metadata writes it."""
    if callable(value) and not isinstance(value, type):
        return {"__callable__": getattr(value, "__name__", str(value))}
    if isinstance(value, type):
        return {"__class__": value.__name__}
    if isinstance(value, tuple):
        return list(value)
    return value


def save_arch_metadata(module: torch.nn.Module, save_folder, save_name: str) -> Path:
    """Write ``{save_name}_metadata.json`` (architecture name and init
    kwargs), from which this package's ``from_checkpoint`` and
    ``model_from_metadata`` and the JAX package's ``from_checkpoint``
    rebuild the model. Raises ``ValueError`` for a module that was not built
    through a registered model class."""
    kwargs = getattr(module, "_init_kwargs", None)
    if kwargs is None:
        raise ValueError(f"{type(module).__name__} records no init kwargs: it is not a "
                         "registered model")
    folder = Path(save_folder)
    folder.mkdir(parents=True, exist_ok=True)
    meta = {
        "_name": type(module).__name__,
        "_version": _VERSION,
        "init_kwargs": {k: _json_value(v) for k, v in kwargs.items()},
    }
    path = folder / f"{save_name}_metadata.json"
    path.write_text(json.dumps(meta, indent=2))
    return path


def save_checkpoint(module: torch.nn.Module, save_folder, save_name: str) -> Path:
    """Write ``{save_name}_state_dict.msgpack`` (the flax variables
    ``{"params": ...}`` of the module's weights, in their dtypes) and the
    ``{save_name}_metadata.json`` sidecar: the JAX ``save_checkpoint``'s
    layout, which ``load_checkpoint`` and the JAX package's loaders read.
    A model-sharded module (``parallel.mesh.shard_params``) is gathered to
    its whole weights: every rank must call, rank 0 alone writes, and the
    files are written when any rank's call returns. Returns the state
    file's path."""
    from ..parallel import mesh as mesh_lib

    path = Path(save_folder) / f"{save_name}_state_dict.msgpack"
    state = mesh_lib.gather_state_dict(module)
    sharded = bool(getattr(module, "model_parallel_params", None))
    if not sharded or torch.distributed.get_rank() == 0:
        save_arch_metadata(module, save_folder, save_name)
        write_msgpack(path, {"params": to_flax_params(state)})
    if sharded:
        torch.distributed.barrier()
    return path


def load_checkpoint(module: torch.nn.Module, save_folder, save_name: str) -> torch.nn.Module:
    """Load ``{save_name}_state_dict.msgpack`` (``save_checkpoint``'s layout:
    the flax variables, parameters under ``"params"``) into ``module``.

    Leaves are checked by name and shape and cast to the module's dtypes;
    a model-sharded module takes its slices of the whole weights.
    Returns ``module``.
    """
    from ..parallel import mesh as mesh_lib

    variables = read_msgpack(Path(save_folder) / f"{save_name}_state_dict.msgpack")
    if not isinstance(variables, Mapping) or "params" not in variables:
        raise ValueError(f"{save_name}_state_dict.msgpack holds no 'params' tree")
    device = next(module.parameters()).device
    whole = convert_flax_params(variables["params"], mesh_lib.whole_template(module),
                                device=device)
    module.load_state_dict(mesh_lib.cut_state_dict(module, whole))
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
