"""Build and load the package's native libraries.

Each ``csrc/<name>.cu`` holds a plain ``extern "C"`` interface and includes
no PyTorch header. It is compiled with ``nvcc`` for Hopper (``sm_90a``)
into ``_build/lib<name>-<hash>.so`` at first use and loaded with
:mod:`ctypes`; the hash covers the source and the flags, so an edited
source is rebuilt. Each ``csrc/<name>.cpp`` is host code (the neighbour
search), built the same way by ``g++`` with OpenMP. A failed build raises:
there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

_PKG_DIR = Path(__file__).parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")


@dataclass(frozen=True)
class Build:
    """One kernel library: where it is, and what its build took and said."""

    path: Path
    seconds: float  # 0.0 when an earlier build of the same source was reused
    log: str  # nvcc's output, with ptxas' registers and spills per kernel


_lock = threading.Lock()
_builds: Dict[str, Build] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc was not found on PATH, in $CUDA_HOME/bin or in "
            "/usr/local/cuda/bin; the CUDA kernels cannot be built"
        )
    return nvcc


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found on PATH; the host libraries cannot be built")
    return gxx


def _build(name: str, src: Path, find_compiler, flags) -> Build:
    """Compile ``src`` with the compiler ``find_compiler()`` names and
    ``flags`` unless this exact source is built; the build is kept under
    ``name``."""
    with _lock:
        if name in _builds:
            return _builds[name]
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            build = Build(out, 0.0, "")
        else:
            compiler = find_compiler()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build under a temporary name and rename, so that a process
            # that dies mid-build leaves no half-written library behind
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [compiler, *flags, "-o", tmp, str(src)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = res.stdout + res.stderr
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"{Path(compiler).name} failed ({res.returncode}) building {src}:\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, out)
            build = Build(out, seconds, log)
        _builds[name] = build
        return build


def build_library(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` with nvcc unless this exact source is built."""
    src = CSRC_DIR / f"{name}.cu"
    return _build(name, src, find_nvcc, NVCC_FLAGS)


def build_host_library(name: str) -> Build:
    """Compile ``csrc/<name>.cpp`` with g++ unless this exact source is built."""
    src = CSRC_DIR / f"{name}.cpp"
    return _build(name, src, find_gxx, GXX_FLAGS)


def load_library(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it on first use."""
    return ctypes.CDLL(str(build_library(name).path))


def load_host_library(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cpp``, building it on first use."""
    return ctypes.CDLL(str(build_host_library(name).path))
