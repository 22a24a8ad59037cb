"""The spread of the port's FNOGNO car-CFD test figure over initial weights.

Runs ``neuraloperator_tpu_torch.scripts.train_fnogno_carcfd
--data_source synthetic`` (its defaults otherwise: 100 + 20 samples, 20
epochs) once per initial state: the port's own init from each of ``--seeds``,
and, with ``--jax_init FILE``, the JAX script's ``PRNGKey(0)`` weights that
``tools/jax_fnogno_init.py`` wrote. The samples are generated once and shared
by every run. Each run prints its epochs as the script does; then one line
per run and, last, one JSON object of every run's figures and the test
figure's mean, standard deviation, least and most. Imports no JAX.

  python tools/fnogno_init_spread.py --seeds 0 1 2 [--jax_init W.msgpack]
      [--device cpu] [SCRIPT FLAGS]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from neuraloperator_tpu_torch import convert  # noqa: E402
from neuraloperator_tpu_torch.scripts import train_fnogno_carcfd as script  # noqa: E402
from neuraloperator_tpu_torch.serialization import read_msgpack  # noqa: E402


def _run(argv, seed=0, params=None) -> dict:
    build, script.SEED = script.build_model, seed
    if params is not None:
        def load(*args, **kwargs):
            model = build(*args, **kwargs)
            model.load_state_dict(convert.convert_flax_params(
                params, model.state_dict(), device=kwargs["device"]))
            return model

        script.build_model = load
    try:
        t0 = time.perf_counter()
        out = script.main(argv)
        out["wall_s"] = time.perf_counter() - t0
    finally:
        script.build_model, script.SEED = build, 0
    return out


def main(args=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    parser.add_argument("--jax_init", default=None)
    opts, rest = parser.parse_known_args(args)
    argv = ["--data_source", "synthetic", *rest]
    load_samples = script.load_samples
    samples = load_samples(script.make_config_from_cli(script.CarConfig,
                                                       script.split_device(argv)[1]))
    script.load_samples = lambda config: samples
    inits = [(f"seed {s}", {"seed": s}) for s in opts.seeds]
    if opts.jax_init is not None:
        inits.append(("jax PRNGKey(0)", {"params": read_msgpack(opts.jax_init)}))
    runs = {}
    try:
        for name, init in inits:
            out = _run(argv, **init)
            runs[name] = {"test_l2": out["test_l2"], "train_l2": out["train_l2"][-1],
                          "evals": {str(k): v for k, v in out["evals"].items()},
                          "wall_s": out["wall_s"]}
            print(f"{name}: test l2 {out['test_l2']:.5f}, wall {out['wall_s']:.1f} s",
                  flush=True)
    finally:
        script.load_samples = load_samples
    figures = np.array([r["test_l2"] for r in runs.values()])
    summary = {"runs": runs, "test_l2_mean": float(figures.mean()),
               "test_l2_std": float(figures.std(ddof=1)) if len(figures) > 1 else 0.0,
               "test_l2_min": float(figures.min()), "test_l2_max": float(figures.max())}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
