"""Train an FNO-1D on Burgers' equation (port of ``scripts/train_burgers.py``).

The JAX script's config tree and command line (``--section.key value``,
lists as ``[a,b]``), plus ``--device`` (``cuda`` by default; ``cpu`` to run
on the host). The recipe: the FNO at n_modes [8], hidden 24, 4 layers; 100
training pairs at 16 points, 50 test pairs, batch 16; 30 epochs of AdamW
at lr 1e-2 with StepLR(10, 0.5), weight decay 1e-4; H1 to train, H1 and L2
evaluated every 5 epochs. The pairs are ``load_burgers_1d``'s: the files
under ``data/datasets/darcy.DATA_ROOT``, generated there when missing. The
weights are drawn from a generator seeded with 0.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_burgers [--opt.n_epochs 30] \\
      [--device cpu]
"""

from dataclasses import dataclass, field
from typing import List

import torch

from .._common import not_ported, resolve_device
from ..config import ConfigBase, DistributedConfig, FNOModelConfig, OptConfig, make_config_from_cli
from ..data.datasets import load_burgers_1d
from ..losses import H1Loss, LpLoss
from ..models import get_model
from ..training import Trainer, adamw, setup, step_lr
from ..utils import count_model_params
from ._checkpoint_cli import split_device

SEED = 0


@dataclass
class BurgersDataConfig(ConfigBase):
    batch_size: int = 16
    n_train: int = 100
    train_resolution: int = 16
    n_tests: List[int] = field(default_factory=lambda: [50])
    test_resolutions: List[int] = field(default_factory=lambda: [16])
    test_batch_sizes: List[int] = field(default_factory=lambda: [16])


@dataclass
class BurgersConfig(ConfigBase):
    model: FNOModelConfig = field(default_factory=lambda: FNOModelConfig(
        n_modes=[8], hidden_channels=24
    ))
    opt: OptConfig = field(default_factory=lambda: OptConfig(
        n_epochs=30, learning_rate=1e-2, step_size=10
    ))
    data: BurgersDataConfig = field(default_factory=BurgersDataConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    verbose: bool = True
    eval_interval: int = 5


def build_model(config: BurgersConfig, *, device="cuda", generator=None):
    """The config's FNO."""
    return get_model(config.to_dict(), device=device, generator=generator)


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final metrics."""
    device, argv = split_device(argv)
    config = make_config_from_cli(BurgersConfig, argv)
    device = resolve_device(device)
    if config.distributed.use_distributed:
        raise not_ported("--distributed.use_distributed", "distribution")
    setup(config)
    train_loader, test_loaders, data_processor = load_burgers_1d(
        n_train=config.data.n_train,
        n_tests=config.data.n_tests,
        batch_size=config.data.batch_size,
        test_batch_sizes=config.data.test_batch_sizes,
        train_resolution=config.data.train_resolution,
        test_resolutions=config.data.test_resolutions,
    )
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(SEED))
    optimizer = adamw(
        step_lr(config.opt.learning_rate, config.opt.step_size, config.opt.gamma,
                len(train_loader)),
        weight_decay=config.opt.weight_decay,
    )
    h1loss, l2loss = H1Loss(d=1), LpLoss(d=1, p=2)
    trainer = Trainer(
        model=model,
        n_epochs=config.opt.n_epochs,
        data_processor=data_processor,
        eval_interval=config.eval_interval,
        verbose=config.verbose,
        device=device,
    )
    metrics = trainer.train(
        train_loader,
        test_loaders,
        optimizer,
        training_loss=h1loss if config.opt.training_loss == "h1" else l2loss,
        eval_losses={"h1": h1loss, "l2": l2loss},
    )
    if config.verbose:
        print("final:", {k: round(v, 5) for k, v in metrics.items()})
        print(f"model parameters: {count_model_params(trainer.model)}")
    return metrics


if __name__ == "__main__":
    main()
