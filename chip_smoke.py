"""Smoke run of the PyTorch/CUDA port (``neuraloperator_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds as it goes:

1. the card: requires CUDA, prints ``nvidia-smi``'s name and power limit;
2. build: compiles the CUDA kernels from ``neuraloperator_tpu_torch/csrc``
   and prints nvcc's registers and spills per kernel;
3. kernels: runs each kernel against its plain PyTorch version at the
   flagship shapes, and times the kernel, the plain version and one library
   call with CUDA events beside the kernel's byte bound;
4. serve: builds the flagship NS-128 FNO (``artifacts/ns128_v2``) at full
   width with seeded weights and the checkpoint's normalizers, serves
   requests through ``CompiledForward``, checks every answer, the kernel's
   launch count and a batch-3 answer against the same model on the CPU,
   and probes the latency of each bucket;
5. prints one ``{"kernels": [...]}`` line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line. It imports nothing of JAX.
"""

import json
import math
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "ns128_v2"
SEED = 0

# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
L2_BYTES = 50 * 2**20

# the flagship's spectral contraction: 64 x 64 channels over 64 x 33 modes
CHANNELS, MODES = 64, 64 * 33
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
SERVE_TOL = 1e-4
REQUESTS = (3, 1, 8, 3, 8, 1)
BUCKETS = (1, 8)

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def rel_l2(ar, ai, br, bi) -> float:
    ar, ai, br, bi = (t.double() for t in (ar, ai, br, bi))
    num = ((ar - br) ** 2 + (ai - bi) ** 2).sum()
    return float((num / (br ** 2 + bi ** 2).sum()).sqrt())


def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean ms per call by CUDA events.

    The calls walk ``arg_sets`` round robin; the sets together exceed the
    L2 cache, so every call reads its weights from device memory, as each
    layer of the model does.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(iters):
        fn(*arg_sets[k % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def packed_einsum(x2, w2):
    """The library yardstick: the JAX package's packed einsum in one call."""
    return torch.einsum("bim,iom->bom", x2, w2)


def check_mode_contraction(batch: int, dtype: torch.dtype) -> dict:
    """K1 against its plain version at the flagship shape, and its times."""
    from neuraloperator_tpu_torch.ops.spectral_contraction import (
        mode_contraction,
        mode_contraction_reference,
    )

    I = O = CHANNELS
    M = MODES
    size = torch.finfo(dtype).bits // 8
    x_bytes, w_bytes = 2 * batch * I * M * size, 2 * I * O * M * size
    n_sets = max(2, math.ceil(2 * L2_BYTES / (x_bytes + w_bytes)) + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + batch)
    w_std = (2 / (I + O)) ** 0.5 / 2 ** 0.5  # the layer's init scale
    sets = []
    for _ in range(n_sets):
        x = [torch.randn(batch, I, M, generator=gen, device="cuda").to(dtype) for _ in range(2)]
        w = [(w_std * torch.randn(I, O, M, generator=gen, device="cuda")).to(dtype)
             for _ in range(2)]
        sets.append((*x, *w))

    kr, ki = mode_contraction(*sets[0])
    torch.cuda.synchronize()
    pr, pi = mode_contraction_reference(*sets[0])
    err = rel_l2(kr, ki, pr, pi)
    max_abs = float(torch.maximum((kr - pr).abs().max(), (ki - pi).abs().max()))
    name = f"mode_contraction B={batch} {str(dtype).replace('torch.', '')}"
    log(f"{name}: rel_l2 {err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), max_abs {max_abs:.3e}")
    if not err <= KERNEL_TOL[dtype]:
        raise AssertionError(f"{name} disagrees with its plain version: rel_l2 {err}")

    ms = time_ms(mode_contraction, sets, iters=60)
    plain_ms = time_ms(mode_contraction_reference, sets, iters=20)
    packed = [(torch.cat([s[0], s[1]]), torch.cat([s[2], s[3]], dim=1)) for s in sets]
    library_ms = time_ms(packed_einsum, packed, iters=20)
    out_bytes = 2 * batch * O * M * 4
    flops = 8 * batch * I * O * M
    bytes_s = (x_bytes + w_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_s = flops / PEAK_FLOPS[dtype]
    result = {
        "batch": batch, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"B": batch, "I": I, "O": O, "M": M},
        "rel_l2": err, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "bytes": x_bytes + w_bytes + out_bytes, "flops": flops,
    }
    log(f"{name}: kernel {ms:.4f} ms, bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}), plain {plain_ms:.4f} ms, packed einsum {library_ms:.4f} ms")
    return result


def serve() -> dict:
    """The flagship FNO served through CompiledForward; returns its numbers."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.ops.spectral_contraction import mode_contraction
    from neuraloperator_tpu_torch.serving import CompiledForward

    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    t0 = time.perf_counter()
    model = model_from_metadata(
        meta, device="cuda", generator=torch.Generator().manual_seed(SEED)
    )
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = meta["init_kwargs"]["n_layers"]
    log(f"serve: FNO {meta['init_kwargs']['n_modes']} modes, hidden "
        f"{meta['init_kwargs']['hidden_channels']}, {n_layers} layers, {n_params} "
        f"parameters, seeded weights in {time.perf_counter() - t0:.1f} s")
    processor = load_data_processor(FLAGSHIP)
    if processor is None:
        raise FileNotFoundError(f"no data_processor.json in {FLAGSHIP}")
    example = torch.zeros(1, 1, 128, 128)
    normalizers = dict(
        preprocess_fn=processor.in_normalizer.transform,
        postprocess_fn=processor.out_normalizer.inverse_transform,
    )
    served = CompiledForward(model, example, batch_sizes=BUCKETS, device="cuda", **normalizers)
    log(f"serve: buckets {served.batch_sizes}, first runs (s) {served.compile_seconds}")

    gen = torch.Generator().manual_seed(SEED + 1)
    in_std = float(processor.in_normalizer.std.ravel()[0])
    requests = [in_std * torch.randn(n, 1, 128, 128, generator=gen) for n in REQUESTS]
    mode_contraction.launches = 0
    t0 = time.perf_counter()
    answers = []
    for x in requests:
        answers.append(served(x))
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = mode_contraction.launches
    for x, y in zip(requests, answers):
        if tuple(y.shape) != tuple(x.shape):
            raise AssertionError(f"answer of shape {tuple(y.shape)} to a {tuple(x.shape)} request")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"non-finite answer to a batch-{x.shape[0]} request")
    log(f"serve: {len(REQUESTS)} requests of batch {REQUESTS} answered in {serve_s:.3f} s, "
        f"shapes and finiteness checked; kernel launches {launches}")
    if launches != n_layers * len(REQUESTS):
        raise AssertionError(
            f"mode_contraction launched {launches} times for {len(REQUESTS)} "
            f"forwards of {n_layers} spectral layers"
        )

    # the same model on the CPU, through the plain versions
    cpu_model = model_from_metadata(meta, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch3 = REQUESTS.index(3)
    cpu_served = CompiledForward(cpu_model, example, batch_sizes=(3,), device="cpu", **normalizers)
    ref = cpu_served(requests[batch3])
    got = answers[batch3].cpu()
    err = float((got.double() - ref.double()).norm() / ref.double().norm())
    log(f"serve: batch-3 answer vs CPU run rel_l2 {err:.3e} (tol {SERVE_TOL:.0e})")
    if not err <= SERVE_TOL:
        raise AssertionError(f"GPU and CPU answers differ: rel_l2 {err}")

    latency_ms = {b: 1e3 * served.latency_probe(batch_size=b, iters=20) for b in BUCKETS}
    log(f"serve: latency_probe ms per forward {latency_ms}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return {"launches": launches, "latency_ms": latency_ms, "rel_l2_vs_cpu": err,
            "requests": list(REQUESTS), "serve_s": serve_s}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; run it on the GPU machine")
    card = card_line()
    print(card, flush=True)
    log(f"card: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from neuraloperator_tpu_torch import _native

    build = _native.build_library("spectral_contraction")
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"build: spectral_contraction.cu in {build.seconds:.1f} s"
        + ("" if build.seconds else " (reused an earlier build)"))
    for line in ptxas:
        print(f"    {line}", flush=True)

    variants = [check_mode_contraction(b, dt)
                for dt in (torch.float32, torch.bfloat16) for b in BUCKETS]
    served = serve()

    main_variant = next(v for v in variants if v["dtype"] == "float32" and v["batch"] == max(BUCKETS))
    kernels = [{
        "name": "mode_contraction",
        "route": "cuda",
        "source": "neuraloperator_tpu_torch/csrc/spectral_contraction.cu",
        "replaces": "neuraloperator_tpu/ops/pallas/spectral_contraction.py:140",
        "launches": served["launches"],
        "max_abs_err": main_variant["max_abs_err"],
        "rel_l2": main_variant["rel_l2"],
        "ms": main_variant["ms"],
        "kernel_ms": main_variant["ms"],
        "plain_ms": main_variant["plain_ms"],
        "bound_ms": main_variant["bound_ms"],
        "bound_by": main_variant["bound_by"],
        "library_ms": main_variant["library_ms"],
        "shape": main_variant["shape"],
        "variants": variants,
    }]
    log(f"done in {time.perf_counter() - _T0:.1f} s; served latency ms {served['latency_ms']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
