"""Train OTNO on car-CFD surface pressure through optimal transport (port
of ``scripts/train_otno_carcfd.py``).

Each mesh's vertices are centred and scaled to [-1, 1]; an entropic OT plan
between a ``latent_size``² grid on a sphere wrapping the mesh and the
vertices (log-domain Sinkhorn in float64 on the device, ``reg``, 200
iterations; ``data/datasets/ot_datamodule.py``) gives the transported
features (1, 6, s, s) and the decoder map; OTNO (the FNO at modes (12, 12),
hidden 32, 4 layers) runs on the latent grid and its output is gathered
back to the vertices. The samples as in ``train_gino_carcfd``
(``--data_source synthetic``, 2048-vertex bodies, or the default ``mini``,
which the repository does not ship). AdamW at lr ``learning_rate`` (no
weight decay) on the relative L2 (``LpLoss(d=1)``), one mesh a step; the
mean test relative L2 every ``eval_interval`` epochs and at the end. The
weights are drawn from a generator seeded with 0. The JAX script's flags
(``--key value``), plus ``--device`` (``cuda`` by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_otno_carcfd \\
      --data_source synthetic [--n_epochs 30] [--device cpu]
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import OTDataModule
from ..losses import LpLoss
from ..models import OTNO
from ..training import adamw, setup
from ._checkpoint_cli import split_device
from .train_gino_carcfd import load_samples

SEED = 0
OT_ITERS = 200


@dataclass
class OTConfig(ConfigBase):
    n_epochs: int = 30
    learning_rate: float = 1e-3
    latent_size: int = 24
    reg: float = 5e-3
    verbose: bool = True
    # 'mini': the reference's 3-sample mini_car.pt; 'synthetic': the
    # package's deformed-ellipsoid set at n_train/n_test scale
    data_source: str = "mini"
    n_train: int = 100
    n_test: int = 20
    eval_interval: int = 10


def build_model(config: OTConfig, *, device="cuda", generator=None) -> OTNO:
    """The script's OTNO."""
    return OTNO(n_modes=(12, 12), in_channels=6, out_channels=1, hidden_channels=32,
                n_layers=4, device=device, generator=generator)


def prep(sample, config: OTConfig, device):
    """(transported features (1, 6, s, s), decoder map (n_verts,), pressure
    (1, n_verts)) on ``device``: the vertices centred and scaled by their
    largest coordinate, in float32 as the JAX script does, then the OT maps
    on ``device``."""
    verts = sample["vertices"].astype(np.float32)
    center = verts.mean(0)
    scale = np.abs(verts - center).max()
    verts = (verts - center) / scale
    dm = OTDataModule(verts, latent_size=config.latent_size, reg=config.reg,
                      n_iters=OT_ITERS, device=device)
    press = torch.from_numpy(sample["press"].astype(np.float32)).to(device)
    return dm.transported_features(verts), dm.ind_dec, press


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    final test figure, each epoch's mean training loss, the evaluations and
    the seconds the OT maps took."""
    device, argv = split_device(argv)
    config = make_config_from_cli(OTConfig, argv)
    device = resolve_device(device)
    setup()
    train, test = load_samples(config)
    t0 = time.perf_counter()
    batches = [prep(s, config, device) for s in train]
    test_batches = [prep(s, config, device) for s in test]
    if device.type == "cuda":
        torch.cuda.synchronize()
    ot_s = time.perf_counter() - t0
    if config.verbose:
        print(f"OT maps of {len(batches) + len(test_batches)} meshes in {ot_s:.2f} s",
              flush=True)
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(SEED))
    opt = adamw(config.learning_rate).bind(model.named_parameters())
    l2 = LpLoss(d=1)

    def loss_of(x, ind_dec, y):
        return l2(model(x, ind_dec)[None], y[None])

    def eval_test() -> float:
        with torch.no_grad():
            return float(np.mean([float(loss_of(*b)) for b in test_batches]))

    train_l2, evals = [], {}
    for epoch in range(config.n_epochs):
        losses = []
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            loss = loss_of(*batch)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        train_l2.append(float(np.mean(losses)))
        if config.verbose:
            msg = f"[{epoch}] train l2 {train_l2[-1]:.5f}"
            if (epoch + 1) % config.eval_interval == 0:
                evals[epoch] = eval_test()
                msg += f" test l2 {evals[epoch]:.5f}"
            print(msg, flush=True)

    final = eval_test()
    print(f"final test l2: {final:.5f}")
    return {"test_l2": final, "train_l2": train_l2, "evals": evals, "ot_s": ot_s,
            "ot_meshes": len(batches) + len(test_batches)}


if __name__ == "__main__":
    main()
