"""Import and device hygiene of the PyTorch port.

The port and ``chip_smoke.py`` run on a machine without JAX, so they must
import nothing of ``jax``, ``flax``, ``optax`` or the JAX package; and the
entry points must refuse to fall back to the CPU unless asked to.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "neuraloperator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "neuraloperator_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    served = CompiledForward(model, torch.zeros(1, 1, 8, 8), device="cpu")
    assert served(torch.zeros(1, 1, 8, 8)).device.type == "cpu"


def test_chip_smoke_fails_without_a_card(no_card):
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
