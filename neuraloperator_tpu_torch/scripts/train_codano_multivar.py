"""CODANO against a parameter-matched FNO on a multi-variable task (port of
``scripts/train_codano_multivar.py``).

The task: ``n_vars`` coupled fields on a 2-D torus with identical
per-variable physics and a symmetric coupling,

    m   = mean_j x_j
    y_i = A x_i + B m + 0.5 * LP( (P x_i) * (P m) )

with A, B fixed random band-limited spectral multipliers and P, LP low-pass
projections: permutation-equivariant over the variables. CODANO's
codomain attention matches that symmetry and can be extended to more
variables (``extend_variable_ids``); a plain FNO cannot load 2-variable
weights for 3 variables.

Arms, seeded and run one after the other:
  codano_pre        train on (u, v) for ``--pretrain_epochs``, extend to
                    w, fine-tune ``--ft_epochs`` on (u, v, w)
  codano_scratch_ft 3 variables from scratch at the fine-tune budget
  fno_ft            the parameter-matched FNO at the fine-tune budget
  codano_scratch    3 variables from scratch at the full budget
  fno_full          the parameter-matched FNO at the full budget

Each arm is an eager loop over AdamW (weight decay 1e-4) on minibatches of
the training set, in an order drawn per epoch from a ``torch.Generator``
seeded with (0, epoch) (the JAX script draws it with
``jax.random.permutation``); the loss is the mean per-sample relative l2.
The data are made on the host by ``make_dataset``, a copy of the JAX
script's. The models' weights come from generators seeded with 0 (the
2-variable CODANO), 1 (the extension's encoding), 2 (the 3-variable
CODANO) and 3 (the FNO). Prints one JSON line of the arms' results and
appends it to ``artifacts/results.jsonl`` unless ``--no_results``. The JAX
script's flags, plus ``--device`` (``cuda`` by default).

Usage:
  python -m neuraloperator_tpu_torch.scripts.train_codano_multivar --no_results \\
      [--n_train 512 --pretrain_epochs 150] [--device cpu]
"""

import argparse
import copy
import json
import time
from pathlib import Path

import numpy as np
import torch

from .._common import resolve_device
from ..models import CODANO, FNO, extend_variable_ids
from ..training import adamw
from ..utils import count_model_params

RES = 32
VAR_IDS = ("u", "v", "w")
RESULTS = Path(__file__).resolve().parents[2] / "artifacts" / "results.jsonl"


def _spectral_multiplier(rng, res, kmax):
    kx = np.fft.fftfreq(res)[:, None] * res
    ky = np.fft.rfftfreq(res)[None, :] * res
    band = (np.abs(kx) <= kmax) & (ky <= kmax)
    mult = rng.randn(res, res // 2 + 1) * band
    return mult.astype(np.float64)


def make_dataset(n, n_vars, seed, ops_seed=123):
    """(x, y), float32 (n, n_vars, RES, RES), of the permutation-equivariant
    coupled operator; the operators are the same for every split."""
    opr = np.random.RandomState(ops_seed)
    A = _spectral_multiplier(opr, RES, kmax=8)
    B = _spectral_multiplier(opr, RES, kmax=8)
    kx = np.fft.fftfreq(RES)[:, None] * RES
    ky = np.fft.rfftfreq(RES)[None, :] * RES
    P = ((np.abs(kx) <= 4) & (ky <= 4)).astype(np.float64)
    LP = ((np.abs(kx) <= 8) & (ky <= 8)).astype(np.float64)

    r = np.random.RandomState(seed)
    # band-limited random input fields (|k| <= 8)
    xh = (r.randn(n, n_vars, RES, RES // 2 + 1)
          + 1j * r.randn(n, n_vars, RES, RES // 2 + 1)) * LP
    x = np.fft.irfft2(xh, s=(RES, RES))
    x /= x.std()

    xh = np.fft.rfft2(x)
    mh = xh.mean(axis=1, keepdims=True)
    lin = np.fft.irfft2(A * xh + B * mh, s=(RES, RES))
    px = np.fft.irfft2(P * xh, s=(RES, RES))
    pm = np.fft.irfft2(P * mh, s=(RES, RES))
    quad = np.fft.irfft2(LP * np.fft.rfft2(px * pm), s=(RES, RES))
    y = lin + 0.5 * quad
    return x.astype(np.float32), y.astype(np.float32)


def rel_l2(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean per-sample relative l2 over all variables."""
    num = torch.sqrt(torch.sum((out - y) ** 2, dim=(1, 2, 3)))
    den = torch.sqrt(torch.sum(y ** 2, dim=(1, 2, 3))) + 1e-8
    return torch.mean(num / den)


def permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """The epoch's order of the ``n`` training samples."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed * 1_000_003 + epoch))


def train_arm(model, data, epochs, lr, batch, seed=0, log_every=25, label="",
              variable_ids=None):
    """Train a copy of ``model`` on ``data`` = (xtr, ytr, xte, yte), device
    tensors; returns (the trained copy, its test rel_l2, wall seconds)."""
    xtr, ytr, xte, yte = data
    model = copy.deepcopy(model).train()
    kwargs = {} if variable_ids is None else {"input_variable_ids": list(variable_ids)}
    opt = adamw(lr, weight_decay=1e-4).bind(model.named_parameters())
    n = xtr.shape[0]
    steps = n // batch

    def evaluate() -> float:
        with torch.no_grad():
            return float(rel_l2(model(xte, **kwargs), yte))

    t0 = time.time()
    for e in range(epochs):
        order = permutation(seed, e, n)[: steps * batch].to(xtr.device)
        losses = []
        for idx in order.reshape(steps, batch):
            opt.zero_grad(set_to_none=True)
            loss = rel_l2(model(xtr[idx], **kwargs), ytr[idx])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if e % log_every == 0 or e == epochs - 1:
            tr = float(torch.stack(losses).mean())
            print(f"  [{label}] ep {e}: train {tr:.4f} test {evaluate():.4f}", flush=True)
    return model, evaluate(), time.time() - t0


def build_codano(variable_ids, cfg, *, device="cuda", generator=None) -> CODANO:
    return CODANO(
        n_modes=((cfg.n_modes, cfg.n_modes),) * cfg.n_layers,
        n_layers=cfg.n_layers,
        hidden_variable_codimension=cfg.hidden_variable_codimension,
        lifting_channels=cfg.lifting_channels,
        projection_channels=cfg.projection_channels,
        use_positional_encoding=True,
        positional_encoding_dim=cfg.positional_encoding_dim,
        variable_ids=tuple(variable_ids),
        per_channel_attention=False,
        attention_token_dim=cfg.attention_token_dim,
        domain_padding=None,
        device=device,
        generator=generator,
    )


def build_fno(hidden: int, cfg, *, device="cuda", generator=None) -> FNO:
    return FNO(n_modes=(cfg.n_modes, cfg.n_modes), in_channels=3, out_channels=3,
               hidden_channels=hidden, n_layers=cfg.n_layers, device=device,
               generator=generator)


def matched_fno_width(cfg, n_target: int):
    """(hidden, parameter count) of the FNO whose count is nearest
    ``n_target``, hidden 8 to 64 in steps of 2 (the first on a tie);
    counted from the shapes, on the meta device."""
    best = None
    for hidden in range(8, 65, 2):
        cnt = count_model_params(build_fno(hidden, cfg, device="meta"))
        if best is None or abs(cnt - n_target) < abs(best[1] - n_target):
            best = (hidden, cnt)
    return best


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_train", type=int, default=512)
    ap.add_argument("--n_test", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pretrain_epochs", type=int, default=150)
    ap.add_argument("--ft_epochs", type=int, default=30)
    ap.add_argument("--full_epochs", type=int, default=150)
    ap.add_argument("--learning_rate", type=float, default=2e-3)
    ap.add_argument("--ft_learning_rate", type=float, default=1e-3)
    ap.add_argument("--n_modes", type=int, default=8)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--hidden_variable_codimension", type=int, default=16)
    ap.add_argument("--lifting_channels", type=int, default=32)
    ap.add_argument("--projection_channels", type=int, default=32)
    ap.add_argument("--positional_encoding_dim", type=int, default=4)
    ap.add_argument("--attention_token_dim", type=int, default=8)
    ap.add_argument("--no_results", action="store_true",
                    help="skip appending to artifacts/results.jsonl")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the script on ``argv`` (``sys.argv[1:]`` when None); returns the
    result it prints."""
    cfg = parse_args(argv)
    device = resolve_device(cfg.device)
    rows = {}

    def on_device(*arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    x2tr, y2tr = make_dataset(cfg.n_train, 2, seed=10)
    x3tr, y3tr = make_dataset(cfg.n_train, 3, seed=11)
    x3te, y3te = make_dataset(cfg.n_test, 3, seed=12)
    data2 = on_device(x2tr, y2tr, *make_dataset(cfg.n_test, 2, seed=13))
    data3 = on_device(x3tr, y3tr, x3te, y3te)

    # CODANO: pretrain on (u, v), extend to w, fine-tune on (u, v, w)
    cod2 = build_codano(VAR_IDS[:2], cfg, device=device,
                        generator=torch.Generator().manual_seed(0))
    print(f"CODANO params (2-var): {count_model_params(cod2)}")
    cod2, pre_test2, t_pre = train_arm(cod2, data2, cfg.pretrain_epochs, cfg.learning_rate,
                                       cfg.batch, label="codano 2-var pretrain",
                                       variable_ids=VAR_IDS[:2])
    rows["codano_pretrain_2var"] = {"test_l2_2var": pre_test2, "wall_s": round(t_pre, 1)}

    cod3, _ = extend_variable_ids(cod2, cod2.state_dict(), ["w"],
                                  generator=torch.Generator().manual_seed(1))
    # zero-shot: the pretrained physics and a fresh encoding for w
    with torch.no_grad():
        zs = float(rel_l2(cod3(data3[2], input_variable_ids=list(VAR_IDS)), data3[3]))
    print(f"CODANO extended zero-shot 3-var test l2: {zs:.4f}")
    cod3, ft_test, t_ft = train_arm(cod3, data3, cfg.ft_epochs, cfg.ft_learning_rate, cfg.batch,
                                    label="codano extend+finetune", variable_ids=VAR_IDS)
    rows["codano_pre_extend_ft"] = {
        "zero_shot_l2": round(zs, 4), "test_l2": ft_test,
        "epochs": cfg.ft_epochs, "wall_s": round(t_ft, 1),
        "n_params": int(count_model_params(cod3)),
    }

    # CODANO from scratch on 3 variables, at both budgets from one init
    cod3s = build_codano(VAR_IDS, cfg, device=device, generator=torch.Generator().manual_seed(2))
    _, sc_ft, t1 = train_arm(cod3s, data3, cfg.ft_epochs, cfg.learning_rate, cfg.batch,
                             label="codano scratch@ft-budget", variable_ids=VAR_IDS)
    rows["codano_scratch_ft_budget"] = {"test_l2": sc_ft, "epochs": cfg.ft_epochs,
                                        "wall_s": round(t1, 1)}
    cod3s_full, sc_full, t2 = train_arm(cod3s, data3, cfg.full_epochs, cfg.learning_rate,
                                        cfg.batch, label="codano scratch@full",
                                        variable_ids=VAR_IDS)
    rows["codano_scratch_full"] = {"test_l2": sc_full, "epochs": cfg.full_epochs,
                                   "wall_s": round(t2, 1),
                                   "n_params": int(count_model_params(cod3s_full))}

    # the parameter-matched FNO on 3 variables
    n_target = int(count_model_params(cod3s))
    hidden, n_fno = matched_fno_width(cfg, n_target)
    print(f"param-matched FNO: hidden={hidden} ({n_fno} params vs CODANO {n_target})")
    fno = build_fno(hidden, cfg, device=device, generator=torch.Generator().manual_seed(3))
    _, fno_ft, t3 = train_arm(fno, data3, cfg.ft_epochs, cfg.learning_rate, cfg.batch,
                              label="fno@ft-budget")
    rows["fno_ft_budget"] = {"test_l2": fno_ft, "epochs": cfg.ft_epochs,
                             "wall_s": round(t3, 1), "n_params": n_fno}
    _, fno_full, t4 = train_arm(fno, data3, cfg.full_epochs, cfg.learning_rate, cfg.batch,
                                label="fno@full")
    rows["fno_full"] = {"test_l2": fno_full, "epochs": cfg.full_epochs,
                        "wall_s": round(t4, 1), "n_params": n_fno}

    result = {
        "run": "codano_multivar_fair_fight",
        "task": "3-var permutation-equivariant coupled operator, res 32",
        "n_train": cfg.n_train, "n_test": cfg.n_test,
        "arms": rows,
    }
    print(json.dumps(result))
    if not cfg.no_results:
        with RESULTS.open("a") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
