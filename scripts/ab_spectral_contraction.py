"""Time two builds of the spectral-contraction kernels in turns on one GPU.

    python3 scripts/ab_spectral_contraction.py --old OLD.cu [--out DIR] [--sass]

``OLD.cu`` is another version of ``neuraloperator_tpu_torch/csrc/spectral_contraction.cu``
with the same ``extern "C"`` entry points (for example an earlier commit's,
from ``git show <commit>:neuraloperator_tpu_torch/csrc/spectral_contraction.cu``).
Both are built with the package's nvcc flags; ptxas' registers, shared
memory and spills are printed for each. At the flagship shape (I = O = 64,
M = 2112) it runs K1 (``nop_mode_contraction``) in f32 at B = 1, 8, 16 and 32,
K2 (``nop_mode_contraction_dx``) in f32 at B = 8, K1 and K2 in bf16 at
B = 8, and K3 (``nop_mode_contraction_dw``) in f32 and bf16 at B = 8. Each
build is checked against the plain version (and two of its launches
against each other, bit for bit), then timed on the device
(``_timing.device_ms``: the launches queued behind a device-side wait, over
operand sets that exceed the L2 cache) in the order old, new, new, old.
The card's name and power limit head the output; ``DIR/ab_spectral_contraction.json``
holds every number, and ``--sass`` writes both builds' SASS there. Two
yardsticks follow: the card's practical read rate (one ``torch.sum`` over
the f32 weight's bytes), and for K1 at f32 B = 8 each build's host time
per call of its raw entry point (in turns) and the package wrapper's
device and host time per call.
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
from neuraloperator_tpu_torch._timing import device_ms  # noqa: E402
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
I = O = 64
M = 64 * 33
# (kernel, B, dtype); kernel: entry point suffix, plain version, operand shapes
KERNELS = {
    "K1": ("", tsc.mode_contraction_reference, lambda B: ((B, I, M), (I, O, M), (B, O, M))),
    "K2": ("_dx", tsc.mode_contraction_dx_reference, lambda B: ((B, O, M), (I, O, M), (B, I, M))),
    "K3": ("_dw", tsc.mode_contraction_dw_reference, lambda B: ((B, I, M), (B, O, M), (I, O, M))),
}
CASES = [("K1", 8, torch.float32), ("K1", 16, torch.float32), ("K1", 1, torch.float32),
         ("K1", 32, torch.float32),
         ("K2", 8, torch.float32), ("K1", 8, torch.bfloat16), ("K2", 8, torch.bfloat16),
         ("K3", 8, torch.float32), ("K3", 8, torch.bfloat16)]
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


def entry(lib, kernel: str, dtype):
    """The raw entry point of one kernel of a build, as a function of the four operand parts."""
    suffix, _, shapes = KERNELS[kernel]
    fn = getattr(lib, f"nop_mode_contraction{suffix}_{'f32' if dtype == torch.float32 else 'bf16'}")
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run(ar, ai, br, bi):
        B = ar.shape[0]
        out_r = torch.empty(shapes(B)[2], device="cuda")
        out_i = torch.empty_like(out_r)
        err = fn(ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
                 out_r.data_ptr(), out_i.data_ptr(), B, I, O, M, stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out_r, out_i

    return run


def rel_l2(ar, ai, br, bi):
    ar, ai, br, bi = (t.double() for t in (ar, ai, br, bi))
    return float((((ar - br) ** 2 + (ai - bi) ** 2).sum() / (br ** 2 + bi ** 2).sum()).sqrt())


def operand_sets(kernel, B, dtype, seed):
    """Operand sets that together exceed twice the L2, and their bytes per call."""
    a_shape, b_shape, out_shape = KERNELS[kernel][2](B)
    size = torch.finfo(dtype).bits // 8
    moved = 2 * (math.prod(a_shape) + math.prod(b_shape)) * size + 2 * math.prod(out_shape) * 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # a weight operand at the layer's init scale, the others unit normal
    b_scale = 1.0 if kernel == "K3" else (2 / (I + O)) ** 0.5 / 2 ** 0.5
    draw = lambda shape, s=1.0: (s * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)  # noqa: E731
    n_sets = max(2, math.ceil(2 * L2_BYTES / moved) + 1)
    sets = [(draw(a_shape), draw(a_shape), draw(b_shape, b_scale), draw(b_shape, b_scale))
            for _ in range(n_sets)]
    return sets, moved


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
    for kernel, B, dtype in CASES:
        sets, moved = operand_sets(kernel, B, dtype, seed=B)
        fns = {k: entry(lib, kernel, dtype) for k, lib in libs.items()}
        ref = KERNELS[kernel][1](*sets[0])
        check = {}
        for k, fn in fns.items():
            r1, r2 = fn(*sets[0]), fn(*sets[0])
            torch.cuda.synchronize()
            check[k] = {"rel_l2": rel_l2(*r1, *ref),
                        "bit_identical": bool(torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1]))}
        times = {"old": [], "new": []}
        for k in ("old", "new", "new", "old"):
            times[k].append(1e3 * device_ms(fns[k], sets, args.iters)[0])
        dt = str(dtype).replace("torch.", "")
        row = {"kernel": kernel, "B": B, "dtype": dt, "I": I, "O": O, "M": M,
               "bound_us": 1e6 * moved / HBM_BYTES_PER_S, "old_us": times["old"],
               "new_us": times["new"], "check": check}
        results.append(row)
        print(f"{kernel} B={B} {dt}: old {times['old']} us, new {times['new']} us "
              f"(order old, new, new, old), bound {row['bound_us']:.2f} us; {check}", flush=True)

    # The card's practical read rate: one torch.sum over the flagship
    # weight's bytes (69.2 MB in f32), operand sets rotated past the L2
    w_sets = [(torch.randn(2, I, O, M, device="cuda"),) for _ in range(3)]
    sum_us = 1e3 * device_ms(torch.sum, w_sets, args.iters)[0]
    read = {"torch_sum_us": sum_us, "bytes": w_sets[0][0].numel() * 4,
            "tb_per_s": w_sets[0][0].numel() * 4 / sum_us / 1e6}
    print(f"read yardstick, torch.sum over the f32 weight: {read}", flush=True)

    # Host time per call at K1 f32 B=8: each build's raw entry point (its
    # launch path: plan, tensor maps, launch) in turns, and the package's
    # wrapper (shape checks, output allocation, stream lookup, ctypes call)
    sets, _ = operand_sets("K1", 8, torch.float32, seed=8)
    raw = {"old": [], "new": []}
    for k in ("old", "new", "new", "old"):
        raw[k].append(1e3 * device_ms(entry(libs[k], "K1", torch.float32), sets, args.iters)[1])
    ms, host_ms = device_ms(tsc.mode_contraction, sets, args.iters)
    wrapper = {"device_us": 1e3 * ms, "host_us_per_call": 1e3 * host_ms,
               "raw_entry_host_us": raw}
    print(f"K1 f32 B=8 through the package wrapper: {wrapper}", flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "old_source": str(args.old), "ptxas": logs, "cases": results,
              "k1_wrapper": wrapper, "read_yardstick": read, "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    (args.out / "ab_spectral_contraction.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({f"{r['kernel']} B={r['B']} {r['dtype']}": {
        "old_over_new": sum(r["old_us"]) / sum(r["new_us"])} for r in results}))


if __name__ == "__main__":
    main()
