"""Darcy-flow quality runs of UNO, LocalNO and CODANO (port of
``scripts/train_family_quality.py``).

Each family trains on the small-Darcy recipe (the data, loss and schedule
of ``scripts/train_darcy.py``): 1000 training pairs at 16², tests of 100
at 16² and 50 at 32², batch 8, H1 loss, AdamW (weight decay 1e-4) at lr
3e-3 (1e-3 for CODANO) halved every 60 epochs, 300 epochs, evaluations
every 25, through the ``Trainer``'s loader loop. The data are
``load_darcy_flow_small``'s files under ``data/datasets/darcy.DATA_ROOT``,
generated there by the seeded solver when missing; CODANO's input is
normalized too, since its output lives in the input's codomain. The JAX
script's flags, plus ``--device`` (``cuda`` by default). The weights are
drawn from a generator seeded with 0. Prints one JSON line: the family, the
parameter count, the run's size, its wall seconds and the final metrics.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_family_quality --family uno \\
      [--n_train 1000 --n_epochs 300] [--device cpu]
"""

import argparse
import json
import time

import torch

from .._common import resolve_device
from ..data.datasets import load_darcy_flow_small
from ..losses import H1Loss, LpLoss
from ..models import CODANO, UNO, LocalNO
from ..training import Trainer, adamw, step_lr
from ..utils import count_model_params

FAMILIES = ("uno", "local_no", "codano")
SEED = 0


def build_model(family: str, res: int, hvc: int = 32, token_dim: int = 8, *, device="cuda",
                generator=None):
    """The family's recorded configuration (the JAX script's)."""
    kw = dict(device=device, generator=generator)
    if family == "uno":
        return UNO(
            in_channels=1, out_channels=1, hidden_channels=32,
            lifting_channels=64, projection_channels=64, n_layers=5,
            uno_out_channels=(16, 32, 32, 32, 16),
            uno_n_modes=((8, 8),) * 5,
            uno_scalings=((1, 1), (0.5, 0.5), (1, 1), (2, 2), (1, 1)),
            channel_mlp_skip="linear", **kw,
        )
    if family == "local_no":
        return LocalNO(
            n_modes=(16, 16), in_channels=1, out_channels=1,
            hidden_channels=24, n_layers=4,
            default_in_shape=(res, res), **kw,
        )
    if family == "codano":
        return CODANO(
            n_modes=((12, 12),) * 4, n_layers=4,
            hidden_variable_codimension=hvc,
            lifting_channels=64, projection_channels=64,
            per_channel_attention=False, attention_token_dim=token_dim,
            domain_padding=None, **kw,
        )
    raise ValueError(family)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True, choices=list(FAMILIES))
    ap.add_argument("--n_train", type=int, default=1000)
    ap.add_argument("--n_epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--learning_rate", type=float, default=None,
                    help="default: 3e-3 (uno/local_no), 1e-3 (codano)")
    ap.add_argument("--step_size", type=int, default=60)
    ap.add_argument("--eval_interval", type=int, default=25)
    # CODANO capacity knobs (defaults reproduce the recorded row)
    ap.add_argument("--hidden_variable_codimension", type=int, default=32)
    ap.add_argument("--attention_token_dim", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final metrics, unrounded."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    res = 16
    train_loader, test_loaders, data_processor = load_darcy_flow_small(
        n_train=args.n_train, n_tests=[100, 50],
        batch_size=args.batch_size, test_batch_sizes=[16, 16],
        test_resolutions=[16, 32],
        encode_input=(args.family == "codano"), encode_output=True,
    )
    model = build_model(args.family, res, hvc=args.hidden_variable_codimension,
                        token_dim=args.attention_token_dim, device=device,
                        generator=torch.Generator().manual_seed(SEED))
    lr = args.learning_rate or (1e-3 if args.family == "codano" else 3e-3)
    schedule = step_lr(lr, args.step_size, 0.5, len(train_loader))
    optimizer = adamw(schedule, weight_decay=1e-4)
    h1, l2 = H1Loss(d=2), LpLoss(d=2, p=2)
    trainer = Trainer(model=model, n_epochs=args.n_epochs, data_processor=data_processor,
                      eval_interval=args.eval_interval, verbose=True, device=device)
    t0 = time.time()
    metrics = trainer.train(train_loader=train_loader, test_loaders=test_loaders,
                            optimizer=optimizer, training_loss=h1,
                            eval_losses={"h1": h1, "l2": l2})
    out = {
        "family": args.family,
        "n_params": int(count_model_params(trainer.model)),
        "n_train": args.n_train,
        "n_epochs": args.n_epochs,
        "wall_s": round(time.time() - t0, 1),
    }
    out.update({k: round(float(v), 5) for k, v in metrics.items()})
    print(json.dumps(out))
    return metrics


if __name__ == "__main__":
    main()
