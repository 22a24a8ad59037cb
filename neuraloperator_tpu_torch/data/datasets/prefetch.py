"""A prefetching input pipeline (port of ``neuraloperator_tpu/data/datasets/prefetch.py``).

A worker thread collates the next batches from the wrapped loader and moves
them to the device while the consumer trains on the current one; a bounded
queue of ``depth`` batches holds them. On the card each batch is pinned and
copied with ``non_blocking=True`` on a side stream; before a batch is handed
out, the consumer's stream waits for that stream and the batch's tensors are
recorded on the consumer's stream, so their memory is not reused before the
consumer's kernels have read it. An exception in the worker reaches the
consumer at the end of the batches before it; a consumer that stops
early ends the worker at its next batch. With a ``mesh``, each batch is
this data rank's slice of the global batch on the mesh's device
(``parallel.mesh.shard_batch``), which the ``Trainer`` takes as it is.
"""

import queue
import threading
from typing import Iterable, Iterator

import torch

from ..._common import resolve_device
from ...parallel import mesh as mesh_lib


class PrefetchLoader:
    """Wrap a dict-batch iterable: iterating yields the same batches as
    tensors already on ``device`` (``"cuda"`` unless asked otherwise)."""

    _END = object()

    def __init__(self, loader: Iterable, depth: int = 2, mesh=None, device="cuda"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def _place(self, batch: dict, stream) -> dict:
        out = {} if self.mesh is None else mesh_lib.ShardedBatch()
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.mesh is not None and t.ndim > 0:
                out.global_batch_size = len(t)
                t = t[mesh_lib.local_slice(len(t), self.mesh)]
            if stream is None:
                out[k] = t.to(self.device)
                continue
            with torch.cuda.stream(stream):
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
        return out

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        break
                    q.put(self._place(dict(batch), side))
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                q.put(self._END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    break
                if cuda:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_stream(side)
                    for v in item.values():
                        v.record_stream(current)
                yield item
        finally:
            # a consumer that stops early: the worker ends at its next batch
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]


__all__ = ["PrefetchLoader"]
