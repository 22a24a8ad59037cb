"""Fingerprints of the port's seeded initial weights, to compare torch builds.

Prints the torch version, then a SHA-256 prefix of the weights each GNO
script draws from its seeded generator (``train_gino_carcfd``,
``train_fnogno_carcfd``, ``train_poisson``), and of the draws they are made
of (``trunc_normal_``, ``normal_``, ``uniform_`` of a generator seeded with
0). Two machines print the same line only where their torch builds draw the
same numbers. Imports no JAX; draws on the CPU, as the port does.

  python tools/init_fingerprint.py
"""

import hashlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from neuraloperator_tpu_torch.scripts import train_fnogno_carcfd as tfnogno  # noqa: E402
from neuraloperator_tpu_torch.scripts import train_gino_carcfd as tgino  # noqa: E402
from neuraloperator_tpu_torch.scripts import train_poisson as tpois  # noqa: E402


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> dict:
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    draws = {
        "trunc_normal_": lambda t: torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                                               generator=gen()),
        "normal_": lambda t: t.normal_(0.0, 1.0, generator=gen()),
        "uniform_": lambda t: t.uniform_(0.0, 1.0, generator=gen()),
    }
    out = {"torch": torch.__version__}
    out.update({name: digest([fill(torch.empty(4096))]) for name, fill in draws.items()})
    models = {
        "train_gino_carcfd": lambda: tgino.build_model(tgino.CarConfig(), device="cpu",
                                                       generator=gen()),
        "train_fnogno_carcfd": lambda: tfnogno.build_model(tfnogno.CarConfig(), device="cpu",
                                                           generator=gen()),
        "train_poisson": lambda: tpois.build_model(device="cpu", generator=gen()),
    }
    out.update({name: digest(build().state_dict().values()) for name, build in models.items()})
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
