"""Profiling and throughput instrumentation (port of
``neuraloperator_tpu/training/profiling.py``).

``trace`` profiles a block with ``torch.profiler`` (the host and, where
there is a card, its kernels through CUPTI) and writes a Chrome trace,
``trace.json``, to ``logdir``; ``ThroughputMeter`` counts steps and samples
a second, synchronising the device before it reads the clock; and
``flops_per_fno_step`` gives the analytic FLOP count of an FNO step.
"""

import contextlib
import math
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a block: ``with trace(logdir) as d: step(...)`` writes
    ``d/trace.json`` (open it in Perfetto or ``chrome://tracing``). The
    default directory lies under the system's temporary directory."""
    logdir = Path(logdir or Path(tempfile.gettempdir()) / "neuraloperator_tpu_torch_trace")
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield str(logdir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))


class ThroughputMeter:
    """Steps/sec and samples/sec since the step that ends the warm-up.

    Once the process has used the card, every clock read first waits for
    it, so the rates count the work the steps queued, not their launches.
    """

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    @staticmethod
    def _now() -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return time.perf_counter()

    def reset(self) -> None:
        self._t0 = None
        self._steps = 0
        self._samples = 0

    def step(self, n_samples: int = 0) -> None:
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._t0 = self._now()
            self._steps_at_t0 = self._steps
            self._samples_at_t0 = self._samples
        self._samples += n_samples

    @property
    def steps_per_sec(self) -> Optional[float]:
        if self._t0 is None or self._steps <= self._steps_at_t0:
            return None
        return (self._steps - self._steps_at_t0) / (self._now() - self._t0)

    @property
    def samples_per_sec(self) -> Optional[float]:
        sps = self.steps_per_sec
        if sps is None or self._steps == 0:
            return None
        return (self._samples - self._samples_at_t0) / (self._now() - self._t0)


def flops_per_fno_step(
    batch: int,
    resolution,
    n_modes,
    hidden_channels: int,
    n_layers: int,
    in_channels: int = 1,
    out_channels: int = 1,
    lifting_ratio: float = 2,
    projection_ratio: float = 2,
    training: bool = True,
) -> float:
    """Analytic FLOPs of one FNO forward (x3 for forward and backward when
    ``training``): the mode contraction (8 real flops a complex MAC), the
    FFTs (5 N log2 N a transform) and the pointwise MLPs."""
    if isinstance(resolution, int):
        resolution = [resolution] * len(n_modes)
    S = math.prod(resolution)
    kept = math.prod(
        [m if i < len(n_modes) - 1 else m // 2 + 1 for i, m in enumerate(n_modes)]
    )
    C = hidden_channels
    contract = n_layers * kept * C * C * 8 * batch
    fft = n_layers * 2 * C * batch * 5 * S * math.log2(max(S, 2))
    lift = batch * S * (in_channels + len(n_modes)) * lifting_ratio * C * 2
    lift += batch * S * lifting_ratio * C * C * 2
    proj = batch * S * C * projection_ratio * C * 2
    proj += batch * S * projection_ratio * C * out_channels * 2
    mlp = n_layers * batch * S * (C * C // 2) * 2 * 2
    total = contract + fft + lift + proj + mlp
    return 3.0 * total if training else total


__all__ = ["ThroughputMeter", "flops_per_fno_step", "trace"]
