"""Train an FNO on Darcy flow (port of ``scripts/train_darcy.py``).

The JAX script's config tree and command line (``--section.key value``,
lists as ``[a,b]``), plus ``--device`` (``cuda`` by default; ``cpu`` to run
on the host). The data are ``load_darcy_flow_small``'s: the files under
``data/datasets/darcy.DATA_ROOT``, generated there by the seeded scipy
solver when missing. The recipe's defaults (``config.DarcyConfig``): the
FNO_Small2d width, 1000 training pairs at 16², tests at 16² and 32², 300
epochs of H1 at lr 5e-3 with StepLR(60, 0.5), batch 8, the loader loop (the
JAX script has no staged set). The mesh raises ``NotImplementedError``
naming its ROADMAP item.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_darcy --opt.n_epochs 50 \\
      --model.hidden_channels 32 [--device cpu]
"""

from .._common import not_ported, resolve_device
from ..config import DarcyConfig, make_config_from_cli
from ..data.datasets import load_darcy_flow_small
from ..losses import H1Loss, LpLoss
from ..models import get_model
from ..training import Trainer, build_optimizer, setup
from ..utils import count_model_params
from ._checkpoint_cli import split_device


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final metrics."""
    device, argv = split_device(argv)
    config = make_config_from_cli(DarcyConfig, argv)
    device = resolve_device(device)
    if config.distributed.use_distributed:
        raise not_ported("--distributed.use_distributed", "distribution")
    setup(config)

    train_loader, test_loaders, data_processor = load_darcy_flow_small(
        n_train=config.data.n_train,
        n_tests=config.data.n_tests,
        batch_size=config.data.batch_size,
        test_batch_sizes=config.data.test_batch_sizes,
        test_resolutions=config.data.test_resolutions,
        encode_input=config.data.encode_input,
        encode_output=config.data.encode_output,
    )
    model = get_model(config.to_dict(), device=device)
    optimizer = build_optimizer(config.opt, len(train_loader))
    l2loss, h1loss = LpLoss(d=2, p=2), H1Loss(d=2)
    trainer = Trainer(
        model=model,
        n_epochs=config.opt.n_epochs,
        data_processor=data_processor,
        mixed_precision=config.opt.mixed_precision,
        stochastic_rounding=config.opt.stochastic_rounding,
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
