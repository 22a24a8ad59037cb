"""The train step over a dataset staged on the device, captured as a CUDA graph.

The port's counterpart of the JAX ``Trainer``'s epoch program
(``_build_epoch_fn``: one compiled ``lax.scan`` per epoch over batches
gathered by index from the staged dataset). There, one dispatch runs a
whole epoch; here, the step (gather by index, forward, backward with the
contraction kernels K2 and K3, the AdamW update and the add to the loss
sum) is recorded once as a CUDA graph and replayed for every batch, so a
step costs the host one replay instead of a few thousand kernel launches.

The graph's inputs are static buffers: the batch's indices, ``lr_scale``
and the float64 loss sum, which the ``Trainer`` fills between replays. The
optimizer keeps its step count, rate and bias corrections on the device,
so each replay updates them itself. The first step is an eager warm-up
(a real update, counted as a step) on a side stream: it builds the kernels,
caches their occupancy queries, tensor maps and DFT matrices, and makes the
optimizer's state; capture then records the step and runs nothing. A
generator the step draws from (stochastic rounding's) is registered with the
graph, so every replay draws fresh numbers from it instead of the captured
ones. On the CPU the same step runs eagerly. A capture or replay that fails raises: there
is no fallback to the eager step on the card.
"""

from typing import Callable, Dict, Sequence

import torch

from ..ops.spectral_contraction import add_launches, launch_counts


class StagedStep:
    """One train step on staged samples: ``step(index)``.

    ``step_fn(batch, lr_scale)`` is the ``Trainer``'s step (it returns the
    batch's loss); ``data`` maps each key to all the staged samples, on one
    device; every batch holds ``batch_size`` samples; ``generators`` are the
    device generators the step draws random numbers from.
    """

    def __init__(self, step_fn: Callable, data: Dict[str, torch.Tensor], batch_size: int,
                 generators: Sequence[torch.Generator] = ()):
        device = next(iter(data.values())).device
        self.step_fn = step_fn
        self.data = data
        self.generators = tuple(generators)
        self.index = torch.zeros(batch_size, dtype=torch.int64, device=device)
        self.lr_scale = torch.ones((), dtype=torch.float32, device=device)
        self.loss_sum = torch.zeros((), dtype=torch.float64, device=device)
        self.graph = None
        self._launches_per_replay: Dict[str, Dict[str, int]] = {}

    def _body(self) -> None:
        batch = {k: v.index_select(0, self.index) for k, v in self.data.items()}
        self.loss_sum += self.step_fn(batch, self.lr_scale).double()

    def __call__(self, index: torch.Tensor) -> None:
        """Train on the staged samples ``index`` (int64, on the data's device)."""
        self.index.copy_(index)
        if self.index.device.type != "cuda":
            self._body()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            add_launches(self._launches_per_replay)

    def _warm_up_and_capture(self) -> None:
        device = self.index.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(device).wait_stream(side)

        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = launch_counts(by_dtype=True)
        with torch.cuda.graph(graph):
            self._body()
        recorded = launch_counts(by_dtype=True)
        self._launches_per_replay = {
            name: {dt: n - before[name][dt] for dt, n in by_dtype.items()}
            for name, by_dtype in recorded.items()
        }
        # capture ran no kernel: take back what the wrappers counted
        add_launches({name: {dt: -n for dt, n in by_dtype.items()}
                      for name, by_dtype in self._launches_per_replay.items()})
        self.graph = graph
