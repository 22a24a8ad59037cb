"""Convert the JAX FNO's parameters into the port's ``state_dict``.

The JAX package keeps parameters as a nested dict (flax ``params``); the
port's modules carry the same names at the same places, so the mapping is
explicit and one to one: the flax path ``("fno_blocks", "conv_0",
"w_weight")`` is the port's ``"fno_blocks.conv_0.w_weight"``. A leaf left
over on either side, or a shape that differs, raises.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ._common import resolve_device


def flatten_flax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": leaf}}`` -> ``{"a.b": leaf}``."""
    flat = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_flax(value, prefix=name + "."))
        else:
            flat[name] = value
    return flat


def check_flax_params(
    params: Mapping[str, Any], port_state: Mapping[str, Any]
) -> None:
    """Raise unless every flax leaf has a port parameter of its shape, and back.

    ``params`` may hold arrays or anything with a ``.shape`` (e.g. the
    ``jax.ShapeDtypeStruct`` leaves of ``jax.eval_shape``); so may
    ``port_state``.
    """
    flat = flatten_flax(params)
    missing = sorted(set(port_state) - set(flat))
    extra = sorted(set(flat) - set(port_state))
    if missing or extra:
        raise ValueError(
            f"flax and port parameters differ: port names without a flax "
            f"leaf {missing}; flax leaves without a port name {extra}"
        )
    for name, ref in port_state.items():
        if tuple(flat[name].shape) != tuple(ref.shape):
            raise ValueError(
                f"{name}: flax shape {tuple(flat[name].shape)} != port shape "
                f"{tuple(ref.shape)}"
            )


def convert_flax_params(
    params: Mapping[str, Any],
    port_state: Mapping[str, torch.Tensor],
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` holding the values of the flax ``params``.

    ``port_state`` is the target model's ``state_dict()`` (names, shapes and
    dtypes). The tensors are placed on ``device``, ``"cuda"`` by default.
    """
    device = resolve_device(device)
    check_flax_params(params, port_state)
    flat = flatten_flax(params)
    return {
        name: torch.from_numpy(np.array(flat[name])).to(device=device, dtype=ref.dtype)
        for name, ref in port_state.items()
    }
