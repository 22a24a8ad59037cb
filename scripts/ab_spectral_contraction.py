"""Time two builds of the spectral-contraction kernels in turns on one GPU.

    python3 scripts/ab_spectral_contraction.py --old OLD.cu [--out DIR] [--sass]

``OLD.cu`` is another version of ``neuraloperator_tpu_torch/csrc/spectral_contraction.cu``
with the same ``extern "C"`` entry points (for example an earlier commit's,
from ``git show <commit>:neuraloperator_tpu_torch/csrc/spectral_contraction.cu``).
Both are built with the package's nvcc flags; ptxas' registers, shared
memory and spills are printed for each. For K3 (``nop_mode_contraction_dw``)
at the flagship shape (I = O = 64, M = 2112) and batches 1, 2 and 8, f32
and bf16, each build is checked against the plain version and timed with
CUDA events over operand sets that exceed the L2 cache, in the order old,
new, new, old. K1 of the current build is timed in the same run as the
machine-independent yardstick (the same 25.8 us byte bound at f32 B=8).
The card's name and power limit head the output; ``DIR/ab_spectral_contraction.json``
holds every number, and ``--sass`` writes both builds' SASS there.
"""

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neuraloperator_tpu_torch import _native  # noqa: E402
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
I = O = 64
M = 64 * 33
CASES = [(8, torch.float32), (8, torch.bfloat16), (1, torch.float32), (2, torch.float32),
         (1, torch.bfloat16)]
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def build(src: Path, name: str):
    """nvcc ``src`` with the package's flags into ``_build``; returns (path, log)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(_native.NVCC_FLAGS).encode())
    out = _native.BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    return out, res.stdout + res.stderr


def ptxas_lines(log: str):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def dw_entry(lib, dtype):
    fn = getattr(lib, f"nop_mode_contraction_dw_{'f32' if dtype == torch.float32 else 'bf16'}")
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run(xr, xi, gr, gi):
        B = xr.shape[0]
        out_r = torch.empty(I, O, M, device="cuda")
        out_i = torch.empty_like(out_r)
        err = fn(xr.data_ptr(), xi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                 out_r.data_ptr(), out_i.data_ptr(), B, I, O, M, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out_r, out_i

    return run


def time_ms(fn, sets, iters):
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for k in range(iters):
        fn(*sets[k % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(ar, ai, br, bi):
    ar, ai, br, bi = (t.double() for t in (ar, ai, br, bi))
    return float((((ar - br) ** 2 + (ai - bi) ** 2).sum() / (br ** 2 + bi ** 2).sum()).sqrt())


def operand_sets(B, dtype, in_bytes, out_bytes, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_sets = max(2, math.ceil(2 * L2_BYTES / (in_bytes + out_bytes)) + 1)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return [(draw(B, I, M), draw(B, I, M), draw(B, O, M), draw(B, O, M)) for _ in range(n_sets)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="the other version's .cu source")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out")
    ap.add_argument("--sass", action="store_true", help="write both builds' SASS to --out")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_spectral_contraction: no CUDA device is available")
    card = card_line()
    print(card, flush=True)
    args.out.mkdir(parents=True, exist_ok=True)

    new_path, new_log = build(_native.CSRC_DIR / "spectral_contraction.cu", "ab_new")
    old_path, old_log = build(args.old, "ab_old")
    logs = {"old": ptxas_lines(old_log), "new": ptxas_lines(new_log)}
    for which, lines in logs.items():
        print(f"ptxas, {which} build:")
        for ln in lines:
            print(f"    {ln}")
    if args.sass:
        for which, path in (("old", old_path), ("new", new_path)):
            sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(path)],
                                  capture_output=True, text=True)
            (args.out / f"sass_{which}.txt").write_text(sass.stdout + sass.stderr)
    libs = {"old": ctypes.CDLL(str(old_path)), "new": ctypes.CDLL(str(new_path))}

    results = []
    for B, dtype in CASES:
        size = torch.finfo(dtype).bits // 8
        in_bytes = 2 * (B * I * M + B * O * M) * size
        out_bytes = 2 * I * O * M * 4
        sets = operand_sets(B, dtype, in_bytes, out_bytes, seed=B)
        fns = {k: dw_entry(lib, dtype) for k, lib in libs.items()}
        ref = tsc.mode_contraction_dw_reference(*sets[0])
        errs = {}
        for k, fn in fns.items():
            r1 = fn(*sets[0])
            r2 = fn(*sets[0])
            torch.cuda.synchronize()
            errs[k] = {"rel_l2": rel_l2(*r1, *ref),
                       "bit_identical": bool(torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1]))}
        times = {"old": [], "new": []}
        for k in ("old", "new", "new", "old"):
            times[k].append(1e3 * time_ms(fns[k], sets, args.iters))
        plan = tsc.mode_contraction_dw_plan(*sets[0])
        row = {"B": B, "dtype": str(dtype).replace("torch.", ""), "I": I, "O": O, "M": M,
               "bound_us": 1e6 * (in_bytes + out_bytes) / HBM_BYTES_PER_S,
               "old_us": times["old"], "new_us": times["new"], "check": errs, "plan": plan}
        results.append(row)
        print(f"K3 B={B} {row['dtype']}: old {times['old']} us, new {times['new']} us "
              f"(order old, new, new, old), bound {row['bound_us']:.2f} us; {errs}; plan {plan}",
              flush=True)

    # The package's wrapper (shape checks, output allocation, stream lookup,
    # ctypes call) around the same K3 entry point, at f32 B=8: its time per
    # call with the device in the loop, and the host's time per call alone
    B, dtype = 8, torch.float32
    sets = operand_sets(B, dtype, 2 * 2 * B * (I + O) * M * 4, 2 * I * O * M * 4, seed=B)
    wrapper = {"raw_entry_us": 1e3 * time_ms(dw_entry(libs["new"], dtype), sets, args.iters),
               "wrapper_us": 1e3 * time_ms(tsc.mode_contraction_dw, sets, args.iters)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(20):
        tsc.mode_contraction_dw(*sets[k % len(sets)])
    wrapper["host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    print(f"K3 f32 B=8 through the package wrapper: {wrapper}", flush=True)

    # K1 of the current build at f32 B=8, the machine-independent yardstick
    gen = torch.Generator(device="cuda").manual_seed(1)
    w_std = (2 / (I + O)) ** 0.5 / 2 ** 0.5
    k1_sets = [(torch.randn(8, I, M, generator=gen, device="cuda"),
                torch.randn(8, I, M, generator=gen, device="cuda"),
                w_std * torch.randn(I, O, M, generator=gen, device="cuda"),
                w_std * torch.randn(I, O, M, generator=gen, device="cuda")) for _ in range(3)]
    k1_us = 1e3 * time_ms(tsc.mode_contraction, k1_sets, args.iters)
    print(f"K1 f32 B=8 (current build): {k1_us:.2f} us", flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "old_source": str(args.old), "ptxas": logs, "k3": results,
              "k1_f32_b8_us": k1_us, "k3_wrapper": wrapper, "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    (args.out / "ab_spectral_contraction.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"k3_f32_b8_new_over_k1": sum(results[0]["new_us"]) / 2 / k1_us}))


if __name__ == "__main__":
    main()
