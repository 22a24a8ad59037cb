"""Reading ``.pt`` splits (port of ``load_pt_as_numpy`` of
``neuraloperator_tpu/data/datasets/pt_dataset.py``; ``PTDataset`` is not
ported yet)."""

from pathlib import Path

import numpy as np
import torch


def load_pt_as_numpy(path) -> dict:
    """A ``.pt`` dict of tensors (as ``scripts/generate_ns_data.py`` writes
    one) as numpy arrays; bool tensors become float32.

    Loaded with ``weights_only=True``: a split holds tensors, never code.
    """
    data = torch.load(Path(path).as_posix(), weights_only=True)
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bool:
                v = v.float()
            out[k] = v.numpy()
        else:
            out[k] = v
    return out
