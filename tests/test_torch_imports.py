"""Import and device hygiene of the PyTorch port.

The port and ``chip_smoke.py`` run on a machine without JAX, so they must
import nothing of ``jax``, ``flax``, ``optax`` or the JAX package, nor
``msgpack``, which that machine lacks too (the port reads checkpoints with
its own reader); and the entry points must refuse to fall back to the CPU
unless asked to.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "neuraloperator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "neuraloperator_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts/ab_spectral_contraction.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    for expected in (
        "chip_smoke.py",
        "neuraloperator_tpu_torch/ops/fourier.py",
        "neuraloperator_tpu_torch/ops/contractions.py",
        "neuraloperator_tpu_torch/ops/spectral_contraction.py",
        "neuraloperator_tpu_torch/models/fno.py",
        "neuraloperator_tpu_torch/serving.py",
        "neuraloperator_tpu_torch/convert.py",
        "neuraloperator_tpu_torch/losses/data_losses.py",
        "neuraloperator_tpu_torch/losses/differentiation.py",
        "neuraloperator_tpu_torch/training/optimizer.py",
        "neuraloperator_tpu_torch/training/trainer.py",
        "neuraloperator_tpu_torch/data/datasets/tensor_dataset.py",
        "neuraloperator_tpu_torch/data/datasets/ns_solver.py",
        "neuraloperator_tpu_torch/data/datasets/pt_dataset.py",
        "neuraloperator_tpu_torch/serialization.py",
        "neuraloperator_tpu_torch/training/training_state.py",
        "neuraloperator_tpu_torch/scripts/eval_ns_checkpoint.py",
        "neuraloperator_tpu_torch/scripts/serve_model.py",
        "neuraloperator_tpu_torch/config.py",
        "neuraloperator_tpu_torch/utils.py",
        "neuraloperator_tpu_torch/training/setup.py",
        "neuraloperator_tpu_torch/training/staged_step.py",
        "neuraloperator_tpu_torch/data/datasets/synthetic.py",
        "neuraloperator_tpu_torch/data/datasets/navier_stokes.py",
        "neuraloperator_tpu_torch/scripts/generate_ns_data.py",
        "neuraloperator_tpu_torch/scripts/train_navier_stokes.py",
        "neuraloperator_tpu_torch/scripts/eval_ns_superres.py",
        "neuraloperator_tpu_torch/scripts/eval_ns_rollout.py",
        "neuraloperator_tpu_torch/scripts/_checkpoint_cli.py",
        "neuraloperator_tpu_torch/layers/scan_fno_block.py",
        "neuraloperator_tpu_torch/layers/channel_mlp.py",
    ):
        assert expected in names
    assert (PORT / "csrc/spectral_contraction.cu").exists()


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_and_smoke_import_with_jax_blocked():
    code = f"""
import importlib, importlib.util, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import neuraloperator_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_card):
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.serving import CompiledForward

    with pytest.raises(RuntimeError, match="device='cpu'"):
        FNO((4, 4), 1, 1, 4)
    model = FNO((4, 4), 1, 1, 4, n_layers=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompiledForward(model, torch.zeros(1, 1, 8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.convert_flax_params({}, {})
    from neuraloperator_tpu_torch.training import Trainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model=model, n_epochs=1)
    from neuraloperator_tpu_torch.scripts import eval_ns_rollout, eval_ns_superres

    flagship = str(ROOT / "artifacts/ns128_v2")
    for script in (eval_ns_superres, eval_ns_rollout):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            script.main(["--save_dir", flagship, "--save_name", "best_model_f16"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_ns_rollout.per_step_rollout_l2(model, None, np.zeros((1, 1, 8, 8), np.float32),
                                            np.zeros((1, 1, 1, 8, 8), np.float32), 1)
    served = CompiledForward(model, torch.zeros(1, 1, 8, 8), device="cpu")
    assert served(torch.zeros(1, 1, 8, 8)).device.type == "cpu"


def _new_entry_points():
    from neuraloperator_tpu_torch.data.datasets import navier_stokes, ns_solver
    from neuraloperator_tpu_torch.models import load_flagship
    from neuraloperator_tpu_torch.scripts import (
        eval_ns_checkpoint,
        eval_ns_rollout,
        eval_ns_superres,
        generate_ns_data,
        serve_model,
        train_navier_stokes,
    )
    from neuraloperator_tpu_torch.training import load_training_state

    flagship = ROOT / "artifacts/ns128_v2"
    zeros = np.zeros((1, 8, 8), np.float32)
    return {
        "load_flagship": lambda: load_flagship(flagship, "best_model_f16"),
        "load_training_state": lambda: load_training_state(flagship, "best_model_f16", {}),
        "simulate_navier_stokes_2d": lambda: ns_solver.simulate_navier_stokes_2d(zeros, T=1.0),
        "make_nsforcing_split": lambda: ns_solver.make_nsforcing_split(1, 8, 0, T=1.0),
        "evaluate": lambda: eval_ns_checkpoint.evaluate(None, None, zeros, zeros, 1),
        "eval_ns_checkpoint.main": lambda: eval_ns_checkpoint.main(["--save_dir", str(flagship)]),
        "serve_model.main": lambda: serve_model.main(["--ckpt_dir", str(flagship)]),
        "solve_navier_stokes_2d": lambda: navier_stokes.solve_navier_stokes_2d(zeros),
        "load_navier_stokes_pt": lambda: navier_stokes.load_navier_stokes_pt(
            8, [8], 4, [4], data_root="/nonexistent", train_resolution=8),
        "generate_ns_data.main": lambda: generate_ns_data.main(["--out", "/nonexistent"]),
        "train_navier_stokes.main": lambda: train_navier_stokes.main(["--opt.n_epochs", "1"]),
        "eval_ns_superres.main": lambda: eval_ns_superres.main(["--save_dir", str(flagship)]),
        "eval_ns_rollout.main": lambda: eval_ns_rollout.main(["--save_dir", str(flagship)]),
    }


@pytest.mark.parametrize("name", ["load_flagship", "load_training_state",
                                  "simulate_navier_stokes_2d", "make_nsforcing_split",
                                  "evaluate", "eval_ns_checkpoint.main", "serve_model.main",
                                  "solve_navier_stokes_2d", "load_navier_stokes_pt",
                                  "generate_ns_data.main", "train_navier_stokes.main",
                                  "eval_ns_superres.main", "eval_ns_rollout.main"])
def test_checkpoint_solver_and_eval_entry_points_refuse_the_cpu_fallback(no_card, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _new_entry_points()[name]()


def test_chip_smoke_fails_without_a_card(no_card):
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
