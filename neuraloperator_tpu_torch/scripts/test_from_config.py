"""Build a model from a config tree and run one forward and backward (port of
``scripts/test_from_config.py``).

The Darcy config (``config.DarcyConfig``) and its command line (``--section.key
value``), plus ``--device`` (``cuda`` unless ``cpu`` is asked for): the
model comes from the ``get_model`` registry, takes a seeded random batch of
2 at 16 points a dim, and the sum of its squared output is differentiated.
Prints ``model NAME: out SHAPE, loss L, N gradient leaves``, as the JAX
script does (the numbers differ: the weights and the batch are drawn by
torch and numpy, not by ``jax.random``).

Usage:
  python -m neuraloperator_tpu_torch.scripts.test_from_config --model.hidden_channels 8 [--device cpu]
"""

import numpy as np
import torch

from .._common import resolve_device
from ..config import DarcyConfig, make_config_from_cli
from ..models import get_model
from ._checkpoint_cli import split_device


def main(argv=None) -> torch.nn.Module:
    device, argv = split_device(argv)
    config = make_config_from_cli(DarcyConfig, argv)
    device = resolve_device(device)
    model = get_model(config.to_dict(), device=device,
                      generator=torch.Generator().manual_seed(1))
    n_dim = len(config.model.n_modes)
    shape = (2, config.model.data_channels) + (16,) * n_dim
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(shape).astype(np.float32))
    out = model(x.to(device))
    loss = torch.sum(out.float() ** 2)
    loss.backward()
    n_leaves = sum(1 for p in model.parameters() if p.grad is not None)
    print(f"model {type(model).__name__}: out {tuple(out.shape)}, "
          f"loss {float(loss):.4f}, {n_leaves} gradient leaves")
    return model


if __name__ == "__main__":
    main()
