"""Train the SFNO on spherical shallow-water dynamics (port of
``scripts/train_sfno_swe.py``).

The recipe: 200 training pairs at 32×64 from the package's SWE generator
(``data/datasets/spherical_swe.py``, made on the host), tests of 40 pairs
at 32×64 and at 64×128 (zero-shot at twice the resolution), batch 32; the
SFNO at n_modes (16, 32), hidden 64, 2 layers, domain padding 0.05; AdamW
at lr 5e-3, weight decay 1e-4, over a cosine annealing of 20 epochs;
sum-reduced L2 to train, mean-reduced to evaluate, every 5 epochs. The
metrics are named after the test resolutions, ``(32, 64)_l2`` and
``(64, 128)_l2``. The JAX script's flags (``--key value``), plus
``--device`` (``cuda`` by default). The weights are drawn from a generator
seeded with 0.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_sfno_swe [--n_epochs 20] \\
      [--device cpu]
"""

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import load_spherical_swe
from ..losses import LpLoss
from ..models import SFNO
from ..training import Trainer, adamw, cosine_annealing, setup
from ..utils import count_model_params
from ._checkpoint_cli import split_device

SEED = 0


@dataclass
class SWEConfig(ConfigBase):
    n_train: int = 200
    n_test: int = 40
    batch_size: int = 32
    nlat: int = 32
    nlon: int = 64
    # zero-shot super-resolution at twice the training resolution
    test_resolutions: List[List[int]] = field(default_factory=lambda: [[32, 64], [64, 128]])
    n_modes: List[int] = field(default_factory=lambda: [16, 32])
    hidden_channels: int = 64
    n_layers: int = 2
    domain_padding: float = 0.05
    n_epochs: int = 20
    learning_rate: float = 5e-3
    save_dir: Optional[str] = None
    save_every: int = 25
    verbose: bool = True


def build_model(config: SWEConfig, *, device="cuda", generator=None) -> SFNO:
    """The recipe's SFNO (three fields in and out)."""
    return SFNO(
        n_modes=tuple(config.n_modes), in_channels=3, out_channels=3,
        hidden_channels=config.hidden_channels, n_layers=config.n_layers,
        domain_padding=config.domain_padding or None, device=device, generator=generator,
    )


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final metrics."""
    device, argv = split_device(argv)
    config = make_config_from_cli(SWEConfig, argv)
    device = resolve_device(device)
    setup()
    test_resolutions = [tuple(r) for r in config.test_resolutions]
    train_loader, test_loaders, _ = load_spherical_swe(
        n_train=config.n_train,
        n_test=config.n_test,
        batch_size=config.batch_size,
        test_batch_sizes=(config.batch_size,) * len(test_resolutions),
        train_resolution=(config.nlat, config.nlon),
        test_resolutions=test_resolutions,
    )
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(SEED))
    optimizer = adamw(cosine_annealing(config.learning_rate, config.n_epochs, len(train_loader)),
                      weight_decay=1e-4)
    l2 = LpLoss(d=2, reduction="sum")
    trainer = Trainer(model=model, n_epochs=config.n_epochs, verbose=config.verbose,
                      eval_interval=5, device=device)
    save_kwargs = ({"save_dir": config.save_dir, "save_every": config.save_every}
                   if config.save_dir else {})
    metrics = trainer.train(train_loader, test_loaders, optimizer, training_loss=l2,
                            eval_losses={"l2": LpLoss(d=2, reduction="mean")}, **save_kwargs)
    if config.verbose:
        print("final:", {k: round(v, 5) for k, v in metrics.items()})
        print(f"model parameters: {count_model_params(trainer.model)}")
    return metrics


if __name__ == "__main__":
    main()
