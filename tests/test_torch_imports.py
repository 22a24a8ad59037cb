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
        "neuraloperator_tpu_torch/ops/complex_einsum.py",
        "neuraloperator_tpu_torch/tensor/__init__.py",
        "neuraloperator_tpu_torch/tensor/factorized.py",
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
        "neuraloperator_tpu_torch/layers/resample.py",
        "neuraloperator_tpu_torch/layers/complex.py",
        "neuraloperator_tpu_torch/layers/normalization_layers.py",
        "neuraloperator_tpu_torch/layers/padding.py",
        "neuraloperator_tpu_torch/data/datasets/darcy.py",
        "neuraloperator_tpu_torch/scripts/train_darcy.py",
        "neuraloperator_tpu_torch/ops/convolution.py",
        "neuraloperator_tpu_torch/layers/differential_conv.py",
        "neuraloperator_tpu_torch/layers/discrete_continuous_convolution.py",
        "neuraloperator_tpu_torch/layers/local_no_block.py",
        "neuraloperator_tpu_torch/layers/coda_layer.py",
        "neuraloperator_tpu_torch/models/local_no.py",
        "neuraloperator_tpu_torch/models/uno.py",
        "neuraloperator_tpu_torch/models/codano.py",
        "neuraloperator_tpu_torch/models/uqno.py",
        "neuraloperator_tpu_torch/scripts/train_family_quality.py",
        "neuraloperator_tpu_torch/scripts/train_uqno_darcy.py",
        "neuraloperator_tpu_torch/ops/sht.py",
        "neuraloperator_tpu_torch/layers/spherical_convolution.py",
        "neuraloperator_tpu_torch/models/sfno.py",
        "neuraloperator_tpu_torch/data/datasets/spherical_swe.py",
        "neuraloperator_tpu_torch/scripts/train_sfno_swe.py",
        "neuraloperator_tpu_torch/scripts/train_mhd64.py",
        "neuraloperator_tpu_torch/scripts/train_codano_multivar.py",
        "neuraloperator_tpu_torch/data/datasets/burgers.py",
        "neuraloperator_tpu_torch/layers/fourier_continuation.py",
        "neuraloperator_tpu_torch/layers/rno_block.py",
        "neuraloperator_tpu_torch/models/rno.py",
        "neuraloperator_tpu_torch/losses/equation_losses.py",
        "neuraloperator_tpu_torch/losses/meta_losses.py",
        "neuraloperator_tpu_torch/scripts/train_burgers.py",
        "neuraloperator_tpu_torch/scripts/train_burgers_pino.py",
        "neuraloperator_tpu_torch/scripts/train_burgers_rno.py",
        "neuraloperator_tpu_torch/layers/gno_weighting_functions.py",
        "neuraloperator_tpu_torch/layers/segment_csr.py",
        "neuraloperator_tpu_torch/layers/neighbor_search.py",
        "neuraloperator_tpu_torch/layers/integral_transform.py",
        "neuraloperator_tpu_torch/layers/gno_block.py",
        "neuraloperator_tpu_torch/models/gino.py",
        "neuraloperator_tpu_torch/models/fnogno.py",
        "neuraloperator_tpu_torch/data/datasets/synthetic_cfd.py",
        "neuraloperator_tpu_torch/data/datasets/mesh_datamodule.py",
        "neuraloperator_tpu_torch/data/datasets/car_cfd_dataset.py",
        "neuraloperator_tpu_torch/data/datasets/nonlinear_poisson.py",
        "neuraloperator_tpu_torch/scripts/train_gino_carcfd.py",
        "neuraloperator_tpu_torch/scripts/train_fnogno_carcfd.py",
        "neuraloperator_tpu_torch/scripts/train_poisson.py",
        "neuraloperator_tpu_torch/data/datasets/ot_datamodule.py",
        "neuraloperator_tpu_torch/data/datasets/car_ot_dataset.py",
        "neuraloperator_tpu_torch/models/otno.py",
        "neuraloperator_tpu_torch/scripts/train_otno_carcfd.py",
        "neuraloperator_tpu_torch/layers/base_spectral_conv.py",
        "neuraloperator_tpu_torch/layers/einsum_utils.py",
        "neuraloperator_tpu_torch/layers/legacy_spectral_convolution.py",
        "neuraloperator_tpu_torch/layers/spectral_projection.py",
        "neuraloperator_tpu_torch/layers/attention_kernel_integral.py",
        "neuraloperator_tpu_torch/models/torch_import.py",
        "neuraloperator_tpu_torch/training/patching.py",
        "neuraloperator_tpu_torch/training/incremental.py",
        "neuraloperator_tpu_torch/training/tensor_galore.py",
        "neuraloperator_tpu_torch/training/profiling.py",
        "neuraloperator_tpu_torch/data/transforms/base_transforms.py",
        "neuraloperator_tpu_torch/data/transforms/patching_transforms.py",
        "neuraloperator_tpu_torch/data/datasets/prefetch.py",
        "neuraloperator_tpu_torch/data/datasets/hdf5_dataset.py",
        "neuraloperator_tpu_torch/scripts/train_incremental_fno_darcy.py",
        "neuraloperator_tpu_torch/scripts/test_from_config.py",
        "neuraloperator_tpu_torch/scripts/merge_ns_train_data.py",
        "neuraloperator_tpu_torch/scripts/compress_checkpoint.py",
        "neuraloperator_tpu_torch/parallel/__init__.py",
        "neuraloperator_tpu_torch/parallel/mesh.py",
        "neuraloperator_tpu_torch/parallel/comm.py",
        "neuraloperator_tpu_torch/parallel/zero.py",
        "neuraloperator_tpu_torch/parallel/distributed_fft.py",
        "neuraloperator_tpu_torch/parallel/launch.py",
        "neuraloperator_tpu_torch/parallel/distributed_sht.py",
        "neuraloperator_tpu_torch/parallel/distributed_gno.py",
        "neuraloperator_tpu_torch/parallel/pipeline.py",
    ):
        assert expected in names
    assert (PORT / "csrc/spectral_contraction.cu").exists()
    assert (PORT / "csrc/neighbor_search.cpp").exists()


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
    from neuraloperator_tpu_torch.models import TFNO

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFNO((4, 4), 1, 1, 4)
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
    # the mesh and setup's distributed path default to the card too
    from neuraloperator_tpu_torch.parallel import mesh
    from neuraloperator_tpu_torch.training.setup import setup

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.init(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup(model_parallel_size=1)


def _new_entry_points():
    from neuraloperator_tpu_torch.data.datasets import navier_stokes, ns_solver
    from neuraloperator_tpu_torch.data.datasets import OTDataModule
    from neuraloperator_tpu_torch.layers import attention_kernel_integral as attention
    from neuraloperator_tpu_torch.layers import legacy_spectral_convolution as legacy
    from neuraloperator_tpu_torch.models import OTNO, load_flagship
    from neuraloperator_tpu_torch.scripts import (
        eval_ns_checkpoint,
        eval_ns_rollout,
        eval_ns_superres,
        generate_ns_data,
        serve_model,
        train_burgers,
        train_burgers_pino,
        train_burgers_rno,
        train_codano_multivar,
        train_darcy,
        train_family_quality,
        train_fnogno_carcfd,
        train_gino_carcfd,
        train_mhd64,
        train_navier_stokes,
        train_otno_carcfd,
        train_poisson,
        train_sfno_swe,
        train_uqno_darcy,
    )
    from neuraloperator_tpu_torch.scripts import (
        compress_checkpoint,
        test_from_config,
        train_incremental_fno_darcy,
    )
    from neuraloperator_tpu_torch.data.datasets import PrefetchLoader
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
        "train_darcy.main": lambda: train_darcy.main(["--opt.n_epochs", "1"]),
        "train_family_quality.main": lambda: train_family_quality.main(["--family", "uno"]),
        "train_uqno_darcy.main": lambda: train_uqno_darcy.main(["--base_epochs", "1"]),
        "build_model": lambda: train_family_quality.build_model("local_no", 16),
        "CODANO": lambda: train_family_quality.build_model("codano", 16),
        "UNO": lambda: train_family_quality.build_model("uno", 16),
        "train_sfno_swe.main": lambda: train_sfno_swe.main(["--n_epochs", "1"]),
        "train_mhd64.main": lambda: train_mhd64.main(["--opt.n_epochs", "1"]),
        "train_codano_multivar.main": lambda: train_codano_multivar.main(["--no_results"]),
        "SFNO": lambda: train_sfno_swe.build_model(train_sfno_swe.SWEConfig()),
        "train_burgers.main": lambda: train_burgers.main(["--opt.n_epochs", "1"]),
        "train_burgers_pino.main": lambda: train_burgers_pino.main(["--n_epochs", "1"]),
        "train_burgers_rno.main": lambda: train_burgers_rno.main(["--n_epochs", "1"]),
        "RNO": lambda: train_burgers_rno.build_model(),
        "train_gino_carcfd.main": lambda: train_gino_carcfd.main(["--data_source", "synthetic"]),
        "train_fnogno_carcfd.main": lambda: train_fnogno_carcfd.main(
            ["--data_source", "synthetic"]),
        "train_poisson.main": lambda: train_poisson.main(["--n_epochs", "1"]),
        "GINO": lambda: train_gino_carcfd.build_model(train_gino_carcfd.CarConfig()),
        "FNOGNO": lambda: train_poisson.build_model(),
        "train_otno_carcfd.main": lambda: train_otno_carcfd.main(["--data_source", "synthetic"]),
        "OTNO": lambda: OTNO((4, 4)),
        "OTDataModule": lambda: OTDataModule(np.zeros((8, 3), np.float32), latent_size=2),
        "SpectralConv2d": lambda: legacy.SpectralConv2d(2, 2, (2, 2)),
        "JointFactorizedSpectralConv": lambda: legacy.JointFactorizedSpectralConv(2, 2, (4, 4)),
        "AttentionKernelIntegral": lambda: attention.AttentionKernelIntegral(4, 4, 1, 4),
        "train_incremental_fno_darcy.main": lambda: train_incremental_fno_darcy.main([]),
        "test_from_config.main": lambda: test_from_config.main([]),
        "compress_checkpoint.main": lambda: compress_checkpoint.main(["--dir", "/nonexistent"]),
        "PrefetchLoader": lambda: PrefetchLoader([]),
    }


@pytest.mark.parametrize("name", ["load_flagship", "load_training_state",
                                  "simulate_navier_stokes_2d", "make_nsforcing_split",
                                  "evaluate", "eval_ns_checkpoint.main", "serve_model.main",
                                  "solve_navier_stokes_2d", "load_navier_stokes_pt",
                                  "generate_ns_data.main", "train_navier_stokes.main",
                                  "eval_ns_superres.main", "eval_ns_rollout.main",
                                  "train_darcy.main", "train_family_quality.main",
                                  "train_uqno_darcy.main", "build_model", "CODANO", "UNO",
                                  "train_sfno_swe.main", "train_mhd64.main",
                                  "train_codano_multivar.main", "SFNO",
                                  "train_burgers.main", "train_burgers_pino.main",
                                  "train_burgers_rno.main", "RNO",
                                  "train_gino_carcfd.main", "train_fnogno_carcfd.main",
                                  "train_poisson.main", "GINO", "FNOGNO",
                                  "train_otno_carcfd.main", "OTNO", "OTDataModule",
                                  "SpectralConv2d", "JointFactorizedSpectralConv",
                                  "AttentionKernelIntegral", "train_incremental_fno_darcy.main",
                                  "test_from_config.main", "compress_checkpoint.main",
                                  "PrefetchLoader"])
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
