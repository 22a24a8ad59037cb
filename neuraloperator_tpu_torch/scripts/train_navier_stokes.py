"""Train the FNO on 2-D Navier–Stokes vorticity (port of ``scripts/train_navier_stokes.py``).

The JAX script's config tree and command line (``--section.key value``,
lists as ``[a,b]``), plus ``--device`` (``cuda`` by default; ``cpu`` to run
on the host). The flagship recipe (``scripts/run_flagship_v2.sh``) runs
as is: the NS splits from ``data/datasets/navier_stokes.py``'s default root
(generated there when missing), ``--device_dataset true`` (the staged set
and the replayed CUDA graph of the step), ``--save_dir`` with
``--save_every`` and ``--save_best``, ``--warm_start_from`` for a first
launch and ``--resume_from_dir`` for every relaunch, in the JAX package's
checkpoint format. The JAX package's mixed-precision run
(``scripts/run_round4_post.sh:23-24``) runs as well: ``--model.weight_dtype
bfloat16 --model.fno_block_precision mixed --opt.mixed_precision true``,
and so do the recipes' optimizer options (``scripts/run_round4_post.sh:26-33``):
``--opt.opt_state factored8``, ``--opt.stochastic_rounding true`` and
``--opt.ema_decay D`` (whose run ends with an evaluation of the EMA of the
parameters, printed as ``ema: {...}``). ``--patching.levels L`` (with
``--patching.padding`` and ``--patching.stitching``) trains the
multigrid-patched FNO (MG-TFNO): the normalizers are wrapped in an
``MGPatchingDataProcessor``, the model takes ``L + 1`` times the data
channels, and a batch of B fields reaches the spectral layers as
``B * 4**L`` patches. The mesh raises ``NotImplementedError`` naming its
ROADMAP item.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_navier_stokes --opt.n_epochs 50 \\
      --data.n_train 20000 --data.train_resolution 128 [--device cpu]
"""

import copy
from dataclasses import dataclass, field
from typing import List, Optional

from .._common import resolve_device
from ..config import (
    ConfigBase,
    DistributedConfig,
    FNOModelConfig,
    OptConfig,
    make_config_from_cli,
)
from ..data.datasets import load_navier_stokes_pt
from ..data.transforms import MGPatchingDataProcessor, load_data_processor
from ..losses import H1Loss, LpLoss
from ..models import get_model
from ..training import Trainer, build_optimizer, ema_params, setup
from ..utils import count_model_params
from ._checkpoint_cli import split_device as _split_device


@dataclass
class NSDataConfig(ConfigBase):
    batch_size: int = 8
    n_train: int = 64
    train_resolution: int = 64
    n_tests: List[int] = field(default_factory=lambda: [16])
    test_resolutions: List[int] = field(default_factory=lambda: [64])
    test_batch_sizes: List[int] = field(default_factory=lambda: [8])
    encode_input: bool = True
    encode_output: bool = True


@dataclass
class PatchingConfig(ConfigBase):
    levels: int = 0
    padding: float = 0.078125
    stitching: bool = True


@dataclass
class NSConfig(ConfigBase):
    model: FNOModelConfig = field(default_factory=lambda: FNOModelConfig(
        n_modes=[24, 24], hidden_channels=32, projection_channel_ratio=4
    ))
    opt: OptConfig = field(default_factory=lambda: OptConfig(
        n_epochs=50, learning_rate=3e-4, step_size=20
    ))
    data: NSDataConfig = field(default_factory=NSDataConfig)
    patching: PatchingConfig = field(default_factory=PatchingConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    verbose: bool = True
    eval_interval: int = 1
    # stage the dataset on the device; on the card the step is a replayed CUDA graph
    device_dataset: bool = False
    # steps per chunk of a staged epoch (None = the whole epoch)
    epoch_scan_chunk: Optional[int] = None
    save_dir: Optional[str] = None  # save best/final training state here
    save_best: Optional[str] = None  # metric name, e.g. '128_l2'
    save_every: Optional[int] = None  # periodic save interval (epochs)
    resume_from_dir: Optional[str] = None  # resume params/opt/epoch from here
    # params-only warm start (fine-tuning: fresh optimizer/schedule/epoch)
    warm_start_from: Optional[str] = None
    warm_start_name: str = "best_model"
    # also load the donor's optimizer.msgpack
    warm_start_opt: bool = False
    # pin the normalizers to another checkpoint's data_processor.json instead
    # of refitting them on this run's train split
    normalizer_from: Optional[str] = None


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final metrics."""
    device, argv = _split_device(argv)
    config = make_config_from_cli(NSConfig, argv)
    device = resolve_device(device)
    # with --distributed.use_distributed: this process's rank of the mesh
    mesh = setup(config, device=device)

    train_loader, test_loaders, data_processor = load_navier_stokes_pt(
        n_train=config.data.n_train,
        n_tests=config.data.n_tests,
        batch_size=config.data.batch_size,
        test_batch_sizes=config.data.test_batch_sizes,
        train_resolution=config.data.train_resolution,
        test_resolutions=config.data.test_resolutions,
        encode_input=config.data.encode_input,
        encode_output=config.data.encode_output,
        device=device,
    )
    if config.normalizer_from is not None:
        pinned = load_data_processor(config.normalizer_from)
        if pinned is None:
            raise SystemExit(f"--normalizer_from {config.normalizer_from}: no "
                             "data_processor.json sidecar found")
        data_processor = pinned
        print(f"normalizers pinned from {config.normalizer_from}")

    if config.patching.levels > 0:
        # get_model multiplies data_channels by levels + 1 for the patched input
        data_processor = MGPatchingDataProcessor(
            levels=config.patching.levels,
            padding_fraction=config.patching.padding,
            stitching=config.patching.stitching,
            use_distributed=config.distributed.use_distributed,
            mesh=mesh,
            in_normalizer=data_processor.in_normalizer,
            out_normalizer=data_processor.out_normalizer,
        )

    model = get_model(config.to_dict(), device=device)
    optimizer = build_optimizer(config.opt, len(train_loader))
    h1loss, l2loss = H1Loss(d=2), LpLoss(d=2, p=2)
    trainer = Trainer(
        model=model,
        n_epochs=config.opt.n_epochs,
        data_processor=data_processor,
        eval_interval=config.eval_interval,
        mixed_precision=config.opt.mixed_precision,
        stochastic_rounding=config.opt.stochastic_rounding,
        verbose=config.verbose,
        device=device,
        mesh=mesh,
    )
    metrics = trainer.train(
        train_loader,
        test_loaders,
        optimizer,
        training_loss=h1loss if config.opt.training_loss == "h1" else l2loss,
        eval_losses={"h1": h1loss, "l2": l2loss},
        device_dataset=config.device_dataset,
        epoch_scan_chunk=config.epoch_scan_chunk,
        resume_from_dir=config.resume_from_dir,
        warm_start_from=config.warm_start_from,
        warm_start_name=config.warm_start_name,
        warm_start_opt=config.warm_start_opt,
        **(
            {
                "save_dir": config.save_dir,
                "save_best": config.save_best,
                "save_every": config.save_every or config.opt.n_epochs,
            }
            if config.save_dir
            else {}
        ),
    )
    if config.opt.ema_decay > 0:
        # a second evaluation, on the EMA of the parameters (which rides the
        # optimizer state), as the JAX script evaluates trainer.params = the
        # EMA: a copy of the model holds the f32 EMA tensors (the trained one
        # keeps its storage, which the step's CUDA graph writes)
        ema = ema_params(trainer.optimizer)
        ema_model = copy.deepcopy(trainer.model)
        for name, p in ema_model.named_parameters():
            p.data = ema[name].clone()
        evaluator = Trainer(model=ema_model, n_epochs=config.opt.n_epochs,
                            data_processor=data_processor,
                            mixed_precision=config.opt.mixed_precision, device=device,
                            mesh=mesh)
        ev = evaluator._build_eval_step({"h1": h1loss, "l2": l2loss})
        ema_metrics = evaluator.evaluate_all(ev, test_loaders)
        if trainer.is_writer:
            print("ema:", {k: round(float(v), 5) for k, v in ema_metrics.items()})
    if config.verbose and trainer.is_writer:
        print("final:", {k: round(v, 5) for k, v in metrics.items()})
        print("params:", count_model_params(trainer.model))
    return metrics


if __name__ == "__main__":
    main()
