"""Kernel times on the card, measured on the device and not at the host's enqueue rate."""

import time
from typing import Callable, Sequence, Tuple

import torch

# Spin cycles per second of host enqueue time to wait on the device: twice
# the H100's top SM clock (1.98 GHz), so the wait outlasts the enqueueing.
_CYCLES_PER_S = 4e9


def device_ms(fn: Callable, arg_sets: Sequence[tuple], iters: int) -> Tuple[float, float]:
    """Mean device ms per call of ``fn``, and the host's ms per call to enqueue it.

    The calls walk ``arg_sets`` round robin (sets that together exceed the
    L2 cache make every call read its operands from device memory). They
    are enqueued behind a device-side wait (``torch.cuda._sleep``) that
    lasts longer than the host takes to enqueue them, so the CUDA events
    around them time the calls back to back on the device. If the wait ran
    out before the host was done (the start event had completed), the wait
    is made longer and the run repeated.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(iters):
        fn(*arg_sets[k % len(arg_sets)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(_CYCLES_PER_S * host_s) + 1_000_000
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for k in range(iters):
            fn(*arg_sets[k % len(arg_sets)])
        host_ms = 1e3 * (time.perf_counter() - t0) / iters
        covered = not start.query()  # the device still waited when the host was done
        end.record()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / iters, host_ms
        cycles *= 4
    raise RuntimeError("the host could not enqueue the timed calls ahead of the device")
