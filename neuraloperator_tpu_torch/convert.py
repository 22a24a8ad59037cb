"""Convert training state between the JAX package's trees and the port's.

The JAX package keeps parameters as a nested dict (flax ``params``); the
port's modules carry the same names at the same places, so the mapping is
explicit and one to one: the flax path ``("fno_blocks", "conv_0",
"w_weight")`` is the port's ``"fno_blocks.conv_0.w_weight"``. A leaf left
over on either side, or a shape that differs, raises.

Both directions are here: flax params to a ``state_dict``
(``convert_flax_params``) and back (``to_flax_params``), and the port's
AdamW state to optax's state tree and back (``adamw_state_to_optax``,
``adamw_state_from_optax``), so a whole training state crosses between the
packages. Parameter trees are built with their keys sorted at every level,
the order ``jax.device_get`` leaves them in before the JAX package saves
them; optax's NamedTuples keep the order of their fields.
"""

from typing import Any, Dict, Mapping, Tuple

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


def as_tensor(leaf) -> torch.Tensor:
    """A leaf (tensor, numpy array or scalar, bfloat16 numpy arrays of
    ``ml_dtypes`` included) as a CPU tensor of its own dtype; a copy unless
    it is a tensor already."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def convert_flax_params(
    params: Mapping[str, Any],
    port_state: Mapping[str, torch.Tensor],
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` holding the values of the flax ``params``.

    ``port_state`` is the target model's ``state_dict()`` (names, shapes and
    dtypes; it may sit on the ``meta`` device). Each leaf is cast to its
    parameter's dtype, as the JAX package casts a checkpoint's leaves to the
    template's on load, so a float16 checkpoint comes back in float32. A
    leaf may be an array or a tensor (``serialization`` returns bfloat16
    leaves as tensors). The tensors are placed on ``device``, ``"cuda"`` by
    default.
    """
    device = resolve_device(device)
    check_flax_params(params, port_state)
    flat = flatten_flax(params)

    return {
        name: as_tensor(flat[name]).to(device=device, dtype=ref.dtype)
        for name, ref in port_state.items()
    }


def unflatten_flax(flat: Mapping[str, Any]) -> dict:
    """``{"a.b": leaf}`` -> ``{"a": {"b": leaf}}``, keys sorted at every level."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return _sorted(tree)


def _sorted(tree):
    if isinstance(tree, Mapping):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax parameter tree of a port ``state_dict`` (the inverse of
    ``convert_flax_params``); its leaves are the state's own tensors."""
    return unflatten_flax({name: t.detach() for name, t in state_dict.items()})


# optax's state of the AdamW policies, as ``flax.serialization`` writes it:
# the chain's tuple as {"0", "1", "2"}, each NamedTuple as a map of its
# fields in their order. "full" is optax.adamw: (ScaleByAdamState(count, mu,
# nu), add_decayed_weights' empty state, ScaleByScheduleState(count));
# "factored" puts FactoredAdamState(count, mu, nu_row, nu_col, nu_full)
# first, and under "factored8" a matrix leaf's mu is Quantized8(codes,
# scale). with_ema wraps the whole as EmaState(inner, ema).
_ADAM_FIELDS = {False: ("count", "mu", "nu"),
                True: ("count", "mu", "nu_row", "nu_col", "nu_full")}
# the port's state key -> (optax field, the leaf's suffix under the name)
_QUANTIZED = {"mu_codes": ".codes", "mu_scale": ".scale"}


def _field_of(key: str, factored: bool) -> Tuple[str, str]:
    """Where a port state key lives in optax's tree: the factored state's
    ``nu_full`` (the second moment of a leaf below two dims) is ``nu``, and
    an int8 first moment's codes and scale are the fields of its
    ``Quantized8``."""
    if key in _QUANTIZED:
        return "mu", _QUANTIZED[key]
    if key == "nu" and factored:
        return "nu_full", ""
    return key, ""


def _mu_leaf(state: Mapping[str, torch.Tensor]):
    if "mu_codes" in state:
        return {"codes": state["mu_codes"], "scale": state["mu_scale"]}
    return state["mu"]


def adamw_state_to_optax(count: int, states: Mapping[str, Mapping[str, torch.Tensor]],
                         factored: bool, clipped: bool = False) -> dict:
    """optax's state tree of the port's AdamW state.

    ``states`` maps each parameter name to its state (``mu`` or, for an
    int8 first moment, ``mu_codes`` and ``mu_scale``; ``nu``, or ``nu_row``
    and ``nu_col`` for a factored leaf of two or more dims; ``ema`` under
    ``with_ema``). A factored optimizer's state holds, as optax's does, f32
    zeros of shape () where a leaf has no such statistic (``nu_row`` and
    ``nu_col`` below two dims, ``nu_full`` from two dims up). ``clipped``:
    the tree of ``optax.chain(optax.clip_by_global_norm(m), adamw)``, whose
    clip keeps an empty state.
    """
    count_leaf = np.asarray(count, dtype=np.int32)
    zero = np.zeros((), np.float32)
    first = {"count": count_leaf}
    for field in _ADAM_FIELDS[factored][1:]:
        if field == "mu":
            first[field] = unflatten_flax({n: _mu_leaf(s) for n, s in states.items()})
            continue
        key = "nu" if field == "nu_full" else field
        first[field] = unflatten_flax(
            {n: s[key] if key in s else zero for n, s in states.items()})
    tree = {"0": first, "1": {}, "2": {"count": count_leaf}}
    if clipped:
        tree = {"0": {}, "1": tree}
    if any("ema" in s for s in states.values()):
        return {"inner": tree, "ema": unflatten_flax({n: s["ema"] for n, s in states.items()})}
    return tree


def adamw_state_from_optax(
    tree: Mapping[str, Any], states: Mapping[str, Mapping[str, torch.Tensor]], factored: bool,
    clipped: bool = False,
) -> Tuple[int, Dict[str, Dict[str, torch.Tensor]]]:
    """``(count, {name: {key: tensor}})`` out of optax's state tree.

    ``states`` is the target optimizer's state (names, keys, shapes and
    dtypes); each leaf is checked against it and cast to its dtype on its
    device. Raises ``ValueError`` on a tree of another policy or of other
    parameters, as ``flax.serialization.from_state_dict`` refuses a tree
    that does not match its template.
    """
    with_ema = any("ema" in s for s in states.values())
    flat: Dict[str, Dict[str, Any]] = {}
    if set(tree) == {"inner", "ema"}:
        if not with_ema:
            raise ValueError("the optimizer state carries an EMA (with_ema); this optimizer "
                             "keeps none")
        flat["ema"] = flatten_flax(tree["ema"])
        tree = tree["inner"]
    elif with_ema:
        raise ValueError(f"this optimizer keeps an EMA; the state tree holds {sorted(tree)}")
    if clipped:
        if set(tree) != {"0", "1"} or tree["0"]:
            raise ValueError("this optimizer clips by the global norm; the state tree holds "
                             f"{sorted(tree)}")
        tree = tree["1"]
    if set(tree) != {"0", "1", "2"} or not isinstance(tree["0"], Mapping):
        raise ValueError(f"not an AdamW state tree: top-level keys {sorted(tree)}")
    first = tree["0"]
    want = _ADAM_FIELDS[factored]
    if set(first) != set(want):
        raise ValueError(
            f"the optimizer state holds {sorted(first)}, this optimizer's policy "
            f"({'factored' if factored else 'full'}) keeps {sorted(want)}"
        )
    flat.update({field: flatten_flax(first[field]) for field in want[1:]})
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, state in states.items():
        out[name] = {}
        for key, ref in state.items():
            field, suffix = ("ema", "") if key == "ema" else _field_of(key, factored)
            leaf = flat[field].get(name + suffix)
            if leaf is None:
                raise ValueError(f"the optimizer state has no {field}{suffix} for {name}")
            if tuple(leaf.shape) != tuple(ref.shape):
                raise ValueError(f"{field}{suffix} of {name}: shape {tuple(leaf.shape)} != "
                                 f"{tuple(ref.shape)}")
            out[name][key] = as_tensor(leaf).to(device=ref.device, dtype=ref.dtype)
    known = set(states) | {name + s for name in states for s in _QUANTIZED.values()}
    extra = set().union(*flat.values()) - known
    if extra:
        raise ValueError(f"the optimizer state has leaves of unknown parameters {sorted(extra)}")
    return int(np.asarray(first["count"])), out
