"""Import reference (PyTorch neuralop) checkpoints into the port's models
(port of ``neuraloperator_tpu/models/torch_import.py``).

The JAX module maps a reference ``state_dict`` onto the flax parameter
tree; the port's parameter names are that tree's paths joined by dots, so
the same key patterns map it straight onto the port's ``state_dict``:

* dense spectral weights (tltorch ``weight.tensor``, complex or
  ``view_as_real``) and the factorized layouts (ComplexTucker
  ``weight.core``/``weight.factors.{i}``, ComplexCP
  ``weight.weights``/``weight.factors.{i}``, ComplexTT
  ``weight.factors.{i}``) onto ``w_weight``/``w_core``/``w_lambdas``/
  ``w_factor_{i}``, split-real ``(2, ...)``; the reference stores the modes
  in the port's order, so only the complex parts are stacked;
* ChannelMLP and skip ``Conv1d`` weights ``(out, in, 1)`` onto ``(out,
  in)``; soft-gating weights as they are;
* UNO's per-layer blocks and horizontal skips, and GINO's GNO kernel
  ``Linear`` stacks (transposed onto flax ``Dense`` kernels).

FNO, TFNO, SFNO, UNO and GINO. A key no pattern covers raises.
"""

import re
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..convert import convert_flax_params, flatten_flax

__all__ = [
    "convert_dense_fno_state_dict",
    "convert_reference_state_dict",
    "load_reference_fno_checkpoint",
]


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().resolve_conj().numpy()
    return np.asarray(t)


def _complex_to_storage(arr: np.ndarray) -> np.ndarray:
    """complex (in, out, modes...) -> split-real (2, in, out, modes...);
    also torch's ``view_as_real`` layout (a trailing axis of 2), which
    tltorch's Complex* factorized tensors use for their factors."""
    if np.iscomplexobj(arr):
        return np.stack([arr.real, arr.imag]).astype(np.float32)
    if arr.shape[-1] == 2:
        return np.moveaxis(arr, -1, 0).astype(np.float32)
    raise ValueError(
        f"expected a complex tensor or view_as_real layout, got shape "
        f"{arr.shape} dtype {arr.dtype}"
    )


def _set(tree: Dict, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


# (key pattern, the flax path it maps to, the transform of its array)
_PATTERNS = [
    (re.compile(r"^(lifting|projection)\.fcs\.(\d+)\.weight$"),
     lambda m: (m.group(1), f"w{m.group(2)}"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^(lifting|projection)\.fcs\.(\d+)\.bias$"),
     lambda m: (m.group(1), f"b{m.group(2)}"),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^fno_blocks\.convs\.(\d+)\.weight(?:\.tensor)?$"),
     lambda m: ("fno_blocks", f"conv_{m.group(1)}", "w_weight"),
     _complex_to_storage),
    # tltorch factorized layouts (reference spectral_convolution.py:362-370;
    # ComplexTucker/ComplexCP/ComplexTT parameters): core/weights/factors
    (re.compile(r"^fno_blocks\.convs\.(\d+)\.weight\.core$"),
     lambda m: ("fno_blocks", f"conv_{m.group(1)}", "w_core"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.convs\.(\d+)\.weight\.weights$"),
     lambda m: ("fno_blocks", f"conv_{m.group(1)}", "w_lambdas"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.convs\.(\d+)\.weight\.factors\.(\d+)$"),
     lambda m: ("fno_blocks", f"conv_{m.group(1)}", f"w_factor_{m.group(2)}"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.convs\.(\d+)\.bias$"),
     lambda m: ("fno_blocks", f"conv_{m.group(1)}", "bias"),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^fno_blocks\.fno_skips\.(\d+)\.conv\.weight$"),
     lambda m: ("fno_blocks", f"fno_skip_{m.group(1)}", "weight"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^fno_blocks\.fno_skips\.(\d+)\.(weight|bias)$"),
     lambda m: ("fno_blocks", f"fno_skip_{m.group(1)}", m.group(2)),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^fno_blocks\.channel_mlp_skips\.(\d+)\.conv\.weight$"),
     lambda m: ("fno_blocks", f"channel_mlp_skip_{m.group(1)}", "weight"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^fno_blocks\.channel_mlp_skips\.(\d+)\.(weight|bias)$"),
     lambda m: ("fno_blocks", f"channel_mlp_skip_{m.group(1)}", m.group(2)),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^fno_blocks\.channel_mlp\.(\d+)\.fcs\.(\d+)\.weight$"),
     lambda m: ("fno_blocks", f"channel_mlp_{m.group(1)}", f"w{m.group(2)}"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^fno_blocks\.channel_mlp\.(\d+)\.fcs\.(\d+)\.bias$"),
     lambda m: ("fno_blocks", f"channel_mlp_{m.group(1)}", f"b{m.group(2)}"),
     lambda a: a.astype(np.float32)),
    # ---- UNO: per-layer FNOBlocks modules `fno_blocks.{i}.*` + horizontal
    # skips (reference models/uno.py:271-312) -> our `block_{i}/*`,
    # `horizontal_skip_{i}` (models/uno.py) ----
    (re.compile(r"^fno_blocks\.(\d+)\.convs\.(\d+)\.weight(?:\.tensor)?$"),
     lambda m: (f"block_{m.group(1)}", f"conv_{m.group(2)}", "w_weight"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.(\d+)\.convs\.(\d+)\.weight\.core$"),
     lambda m: (f"block_{m.group(1)}", f"conv_{m.group(2)}", "w_core"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.(\d+)\.convs\.(\d+)\.weight\.weights$"),
     lambda m: (f"block_{m.group(1)}", f"conv_{m.group(2)}", "w_lambdas"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.(\d+)\.convs\.(\d+)\.weight\.factors\.(\d+)$"),
     lambda m: (f"block_{m.group(1)}", f"conv_{m.group(2)}",
                f"w_factor_{m.group(3)}"),
     _complex_to_storage),
    (re.compile(r"^fno_blocks\.(\d+)\.convs\.(\d+)\.bias$"),
     lambda m: (f"block_{m.group(1)}", f"conv_{m.group(2)}", "bias"),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^fno_blocks\.(\d+)\.fno_skips\.(\d+)\.conv\.weight$"),
     lambda m: (f"block_{m.group(1)}", f"fno_skip_{m.group(2)}", "weight"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^fno_blocks\.(\d+)\.fno_skips\.(\d+)\.(weight|bias)$"),
     lambda m: (f"block_{m.group(1)}", f"fno_skip_{m.group(2)}", m.group(3)),
     lambda a: a.astype(np.float32)),
    (re.compile(
        r"^fno_blocks\.(\d+)\.channel_mlp_skips\.(\d+)\.conv\.weight$"),
     lambda m: (f"block_{m.group(1)}", f"channel_mlp_skip_{m.group(2)}",
                "weight"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^fno_blocks\.(\d+)\.channel_mlp_skips\.(\d+)\.(weight|bias)$"),
     lambda m: (f"block_{m.group(1)}", f"channel_mlp_skip_{m.group(2)}",
                m.group(3)),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^fno_blocks\.(\d+)\.channel_mlp\.(\d+)\.fcs\.(\d+)\.weight$"),
     lambda m: (f"block_{m.group(1)}", f"channel_mlp_{m.group(2)}",
                f"w{m.group(3)}"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^fno_blocks\.(\d+)\.channel_mlp\.(\d+)\.fcs\.(\d+)\.bias$"),
     lambda m: (f"block_{m.group(1)}", f"channel_mlp_{m.group(2)}",
                f"b{m.group(3)}"),
     lambda a: a.astype(np.float32)),
    (re.compile(r"^horizontal_skips\.(\d+)\.conv\.weight$"),
     lambda m: (f"horizontal_skip_{m.group(1)}", "weight"),
     lambda a: a.squeeze(-1).astype(np.float32)),
    (re.compile(r"^horizontal_skips\.(\d+)\.(weight|bias)$"),
     lambda m: (f"horizontal_skip_{m.group(1)}", m.group(2)),
     lambda a: a.astype(np.float32)),
    # ---- GINO: GNOBlock kernel MLPs are torch Linear stacks
    # (`gno_{in,out}.integral_transform.channel_mlp.fcs.{j}`, reference
    # models/gino.py:296-378, layers/channel_mlp.py:122-187); flax Dense
    # kernels are (in, out) = torch weight transposed ----
    (re.compile(
        r"^(gno_in|gno_out)\.integral_transform\.channel_mlp\.fcs\.(\d+)"
        r"\.weight$"),
     lambda m: (m.group(1), "integral_transform", "channel_mlp",
                f"fc{m.group(2)}", "kernel"),
     lambda a: a.T.astype(np.float32)),
    (re.compile(
        r"^(gno_in|gno_out)\.integral_transform\.channel_mlp\.fcs\.(\d+)"
        r"\.bias$"),
     lambda m: (m.group(1), "integral_transform", "channel_mlp",
                f"fc{m.group(2)}", "bias"),
     lambda a: a.astype(np.float32)),
]


def convert_dense_fno_state_dict(state_dict: Mapping,
                                 params_template: Optional[Mapping[str, torch.Tensor]] = None,
                                 ) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` of a reference ``state_dict``.

    Without ``params_template`` the tensors are float32 on the CPU, named as
    the port names them. With it (the target model's ``state_dict()``),
    every converted tensor must land on one of its names with its shape,
    and every name must get one; the tensors take its dtypes, on its device
    (the CPU for a template on ``meta``).
    """
    tree: Dict = {}
    unmatched = []
    for key, value in state_dict.items():
        if key == "_metadata":
            continue
        arr = _to_numpy(value)
        for pat, to_path, tf in _PATTERNS:
            m = pat.match(key)
            if m:
                _set(tree, to_path(m), tf(arr))
                break
        else:
            unmatched.append(key)
    if unmatched:
        raise ValueError(
            "unconverted reference state-dict keys (FNO/TFNO/SFNO/UNO/GINO "
            f"layouts expected): {unmatched}"
        )
    if params_template is None:
        return {name: torch.from_numpy(np.ascontiguousarray(a))
                for name, a in flatten_flax(tree).items()}
    device = next(iter(params_template.values())).device
    return convert_flax_params(tree, params_template,
                               device="cpu" if device.type == "meta" else device)


# the importer covers FNO/TFNO/SFNO/UNO/GINO: the family-neutral name
convert_reference_state_dict = convert_dense_fno_state_dict


def load_reference_fno_checkpoint(save_folder, save_name: str,
                                  params_template: Optional[Mapping[str, torch.Tensor]] = None):
    """``(state_dict, init_kwargs)`` of a reference ``save_checkpoint``
    folder: ``{save_name}_state_dict.pt`` converted as above, and the init
    kwargs of ``{save_name}_metadata.pkl`` (None without it)."""
    save_folder = Path(save_folder)
    state = torch.load(save_folder / f"{save_name}_state_dict.pt", map_location="cpu",
                       weights_only=False)
    meta = save_folder / f"{save_name}_metadata.pkl"
    init_kwargs = torch.load(meta, weights_only=False) if meta.exists() else None
    return convert_dense_fno_state_dict(state, params_template), init_kwargs
