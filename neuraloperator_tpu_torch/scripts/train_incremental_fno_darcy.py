"""Incremental FNO on Darcy flow (the port's counterpart of
``examples/training/plot_incremental_FNO_darcy.py``).

The example's model, data and settings are the defaults: the small Darcy set
(``load_darcy_flow_small``: 200 training pairs at 16², 50 test pairs, batch
16, generated under ``data/datasets/darcy.DATA_ROOT`` when missing), an FNO
of 8 x 8 modes with room for 16 x 16 (``max_n_modes``) and hidden width 24,
10 epochs of L2 at AdamW lr 5e-3, starting at 4 x 4 modes and adding one
whenever the epoch's loss moved by at most 1e-3 (``--criterion loss_gap``;
``grad`` switches to the gradient criterion, which decides every
``--incremental_grad_max_iter`` + 1 epochs with a buffer of
``--incremental_buffer`` modes, the trainer's defaults 10 and 5). Each flag
changes one of them; ``--device`` is ``cuda`` unless ``cpu`` is asked for.
Prints the modes reached and the Trainer's line each epoch, then
``final modes:``.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_incremental_fno_darcy [--device cpu]
"""

import argparse

import torch

from .._common import resolve_device
from ..data.datasets import load_darcy_flow_small
from ..losses import LpLoss
from ..models import FNO
from ..training import adamw
from ..training.incremental import IncrementalFNOTrainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_train", type=int, default=200)
    p.add_argument("--n_test", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_epochs", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=5e-3)
    p.add_argument("--hidden_channels", type=int, default=24)
    p.add_argument("--n_modes", type=int, default=8)
    p.add_argument("--max_n_modes", type=int, default=16)
    p.add_argument("--starting_n_modes", type=int, default=4)
    p.add_argument("--criterion", choices=("loss_gap", "grad"), default="loss_gap")
    p.add_argument("--incremental_eps", type=float, default=1e-3)
    p.add_argument("--incremental_grad_max_iter", type=int, default=10)
    p.add_argument("--incremental_buffer", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the example; returns the last metrics with ``modes_by_epoch`` and
    ``final_modes``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    train_loader, test_loaders, dp = load_darcy_flow_small(
        n_train=args.n_train, n_tests=[args.n_test], batch_size=args.batch_size,
        test_batch_sizes=[args.batch_size], test_resolutions=[16],
    )
    model = FNO(n_modes=(args.n_modes,) * 2, max_n_modes=(args.max_n_modes,) * 2,
                in_channels=1, out_channels=1, hidden_channels=args.hidden_channels,
                device=device, generator=torch.Generator().manual_seed(args.seed))
    criterion = (dict(incremental_loss_gap=True, incremental_loss_eps=args.incremental_eps)
                 if args.criterion == "loss_gap"
                 else dict(incremental_grad=True, incremental_grad_eps=args.incremental_eps,
                           incremental_grad_max_iter=args.incremental_grad_max_iter,
                           incremental_buffer=args.incremental_buffer))
    trainer = IncrementalFNOTrainer(
        model=model, n_epochs=args.n_epochs, data_processor=dp,
        starting_n_modes=(args.starting_n_modes,) * 2, verbose=True, device=device,
        **criterion,
    )
    metrics = trainer.train(train_loader, test_loaders, adamw(args.learning_rate),
                            training_loss=LpLoss(d=2))
    print("final modes:", trainer.current_n_modes)
    return {**metrics, "modes_by_epoch": trainer.modes_by_epoch,
            "final_modes": trainer.current_n_modes}


if __name__ == "__main__":
    main()
