"""Train a UQNO on Darcy flow and calibrate its band (port of
``scripts/train_uqno_darcy.py``).

The training split is carved into solution, residual and calibration
subsets (600 / 250 / 150 of 1000 pairs at 16²). A solution FNO (16x16
modes, hidden 24) trains first through the ``Trainer`` (L2 loss, AdamW at
5e-3, 30 epochs, batch 16); then, with it frozen, a residual FNO of the
same width learns a pointwise quantile band of ``|y - base(x)|`` in
error-std units (``PointwiseQuantileLoss``, a plain autograd loop under the
same AdamW, 30 epochs). The band is conformally calibrated on the held-out
split (``get_coeff_quantile_idx``: the domain-level and function-level
quantile indices from concentration bounds, the matching order statistics
of the |error| / band ratios, the band scaled by that factor), and its
pointwise and function-level coverage measured on the 100 test pairs.
The calibration and the coverage run in numpy on the host; the
calibration and test predictions come from one ``UQNO`` (the solution
detached, the band beside it). The JAX script's ``--key value`` flags,
plus ``--device`` (``cuda`` by default). The solution and residual weights
are drawn from generators seeded with 0 and 1.

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_uqno_darcy \\
      [--base_epochs 30 --residual_epochs 30] [--device cpu]
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._common import resolve_device
from ..config import ConfigBase, make_config_from_cli
from ..data.datasets import DataLoader, TensorDataset, load_darcy_flow_small
from ..losses import LpLoss, PointwiseQuantileLoss
from ..models import FNO, UQNO
from ..training import Trainer, adamw, setup
from ._checkpoint_cli import split_device

BATCH = 16


@dataclass
class UQNOConfig(ConfigBase):
    n_train: int = 1000
    n_train_solution: int = 600
    n_train_residual: int = 250
    n_calib_residual: int = 150
    base_epochs: int = 30
    residual_epochs: int = 30
    alpha: float = 0.1  # target pointwise miscoverage
    delta: float = 0.05  # target function-level miscoverage
    learning_rate: float = 5e-3
    verbose: bool = True
    resolution: int = 16  # >16: synthetic Darcy at this grid size


def get_coeff_quantile_idx(alpha, delta, n_samples, n_gridpts):
    """Quantile indices for conformal calibration: the in-domain
    concentration bound (over grid points) balanced against the
    across-function one (over calibration samples)."""
    lb = np.sqrt(-np.log(delta) / 2 / n_gridpts)
    t = (alpha - lb) / 3 + lb
    percentile = alpha - t
    domain_idx = int(np.ceil(percentile * n_gridpts))
    function_percentile = (
        np.ceil((n_samples + 1) * (delta - np.exp(-2 * n_gridpts * t * t)))
        / n_samples
    )
    function_idx = int(np.ceil(function_percentile * n_samples))
    return domain_idx, function_idx


def build_fno(device, seed: int) -> FNO:
    return FNO(n_modes=(16, 16), in_channels=1, out_channels=1, hidden_channels=24,
               device=device, generator=torch.Generator().manual_seed(seed))


def _batches(x: np.ndarray, fn) -> np.ndarray:
    return np.concatenate([fn(x[i:i + BATCH]) for i in range(0, len(x), BATCH)])


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None). Returns the
    calibration (``domain_idx``, ``function_idx``, ``scale``), the coverages
    (``pointwise``, ``function``), the mean band width, the residual epochs'
    quantile losses and the trained ``uqno``."""
    device, argv = split_device(argv)
    device = resolve_device(device)
    config = make_config_from_cli(UQNOConfig, argv)
    setup()
    train_loader, test_loaders, dp = load_darcy_flow_small(
        n_train=config.n_train, n_tests=[100], batch_size=BATCH,
        test_batch_sizes=[BATCH], test_resolutions=[config.resolution],
        train_resolution=config.resolution,
    )

    # materialize the train split and carve it into solution/residual/calib
    xs, ys = [], []
    for batch in train_loader:
        xs.append(np.asarray(batch["x"]))
        ys.append(np.asarray(batch["y"]))
    x_all, y_all = np.concatenate(xs), np.concatenate(ys)
    n_sol, n_res = config.n_train_solution, config.n_train_residual
    n_cal = config.n_calib_residual
    x_sol, y_sol = x_all[:n_sol], y_all[:n_sol]
    x_res, y_res = x_all[n_sol:n_sol + n_res], y_all[n_sol:n_sol + n_res]
    x_cal = x_all[n_sol + n_res:n_sol + n_res + n_cal]
    y_cal = y_all[n_sol + n_res:n_sol + n_res + n_cal]
    sol_loader = DataLoader(TensorDataset(x_sol, y_sol), BATCH, shuffle=True)

    # 1. train the base solution model
    base = build_fno(device, 0)
    l2 = LpLoss(d=2)
    base_trainer = Trainer(model=base, n_epochs=config.base_epochs, data_processor=dp,
                           verbose=config.verbose, eval_interval=10, device=device)
    base_trainer.train(sol_loader, test_loaders, adamw(config.learning_rate),
                       training_loss=l2, eval_losses={"l2": l2})
    base.eval()

    def raw_input(x_raw: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x_raw).to(device)
        return dp.preprocess({"x": t, "y": t}, train=False)["x"]

    @torch.no_grad()
    def base_predict(x_raw):
        # the frozen base forward in raw space (preprocess -> model -> postprocess)
        out, _ = dp.postprocess(base(raw_input(x_raw)), {}, train=False)
        return out.cpu().numpy()

    # 2. the residual (quantile band) model on |y - base(x)|, trained in
    # error-std units so the quantile loss is well scaled
    err_res = y_res - _batches(x_res, base_predict)
    err_scale = float(np.abs(err_res).std()) + 1e-12
    residual = build_fno(device, 1)
    qloss = PointwiseQuantileLoss(alpha=config.alpha)
    opt = adamw(config.learning_rate).bind(residual.named_parameters())
    res_loader = DataLoader(TensorDataset(x_res, err_res / err_scale), BATCH, shuffle=True)
    epoch_losses = []
    residual.train()
    for epoch in range(config.residual_epochs):
        losses = []
        for batch in res_loader:
            opt.zero_grad(set_to_none=True)
            loss = qloss(residual(raw_input(batch["x"])),
                         torch.from_numpy(batch["y"]).to(device))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        epoch_losses.append(float(torch.stack(losses).double().mean()))
        if config.verbose:
            print(f"[uq {epoch}] quantile loss {epoch_losses[-1]:.5f}")

    uqno = UQNO(base, residual).eval()

    @torch.no_grad()
    def predict(x_raw):
        # the base's raw-space prediction and the band in raw error units,
        # side by side on the channel axis
        solution, band = uqno(raw_input(x_raw))
        solution, _ = dp.postprocess(solution, {}, train=False)
        return np.concatenate([solution.cpu().numpy(),
                               (torch.abs(band) * err_scale).cpu().numpy()], axis=1)

    def errors_and_band(x, y):
        both = _batches(x, predict)
        return np.abs(y - both[:, :1]), both[:, 1:]

    # 3. conformal calibration on the held-out calibration split
    err_cal, band_cal = errors_and_band(x_cal, y_cal)
    ratios = (err_cal / (band_cal + 1e-12)).reshape(len(x_cal), -1)
    n_gridpts = ratios.shape[1]
    domain_idx, function_idx = get_coeff_quantile_idx(
        config.alpha, config.delta, n_samples=len(x_cal), n_gridpts=n_gridpts
    )
    # domain_idx'th largest ratio per function, then function_idx'th largest
    per_fn = np.sort(ratios, axis=1)[:, -(domain_idx + 1)]
    scale = float(np.abs(np.sort(per_fn)[-(function_idx + 1)]))
    print(f"calibration: domain_idx={domain_idx} function_idx={function_idx} "
          f"scale={scale:.4f}")

    # 4. evaluate (alpha, delta) coverage + bandwidth on the test split
    xs, ys = [], []
    for batch in test_loaders[config.resolution]:
        xs.append(np.asarray(batch["x"]))
        ys.append(np.asarray(batch["y"]))
    x_t, y_t = np.concatenate(xs), np.concatenate(ys)
    err_t, band_t = errors_and_band(x_t, y_t)
    band_t = band_t * scale
    inside = (err_t <= band_t).reshape(len(x_t), -1)
    pointwise = inside.mean()
    fn_cov = (inside.mean(axis=1) >= 1 - config.alpha).mean()
    print(f"pointwise coverage: {pointwise:.3f} (target {1-config.alpha})")
    print(f"function coverage (>= {1-config.alpha} pts in-band): "
          f"{fn_cov:.3f} (target {1-config.delta})")
    print(f"mean band width: {band_t.mean():.5f}")
    return {"domain_idx": domain_idx, "function_idx": function_idx, "scale": scale,
            "n_gridpts": n_gridpts, "n_calibration": len(x_cal),
            "pointwise": float(pointwise), "function": float(fn_cov),
            "band_width": float(band_t.mean()), "err_scale": err_scale,
            "residual_losses": epoch_losses, "uqno": uqno}


if __name__ == "__main__":
    main()
