"""Run a function on a group of spawned ranks, with a hard deadline.

``run_ranks(fn, world_size, args)`` starts ``world_size`` fresh processes
(``spawn``), each of which joins one ``torch.distributed`` group (on a
file store in a temporary directory, on gloo, the collectives' timeout
the deadline's) and calls ``fn(rank, world_size, *args)``. It
returns the ranks' results in rank order. A rank that raises, dies or
outlives the deadline ends the whole group: the other processes are
killed and ``RuntimeError`` (or ``TimeoutError``) is raised, so a hung
collective costs seconds, not a run's time limit. ``fn``, ``args`` and the
results are pickled (the first two through a file): ``fn`` must be
importable by name in a fresh process.
"""

import multiprocessing as mp
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist


def _rank_main(job: str, rank: int, world_size: int, init_method: str, timeout_s: float,
               results) -> None:
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        # gloo: NCCL refuses two ranks on one device
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout_s))
        try:
            value = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        # pickled here: a tensor put on the queue as it is would be shared
        # through a descriptor that dies with this process
        results.put((rank, True, pickle.dumps(value)))
    except BaseException:  # reported to the parent, which ends the group
        results.put((rank, False, traceback.format_exc()))


def _end(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_ranks(fn, world_size: int, args=(), *, timeout_s: float = 120.0) -> list:
    """``[fn(r, world_size, *args) for r in range(world_size)]``, each on its
    own spawned rank of one process group (see the module docstring)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init_method = (Path(tmp) / "store").as_uri()
        # the function and its arguments go through a file: a large argument
        # sent down the start pipe would block start() on a rank that dies
        # before it reads it
        job = Path(tmp) / "job.pkl"
        job.write_bytes(pickle.dumps((fn, args)))
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(str(job), r, world_size, init_method, timeout_s, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        done = {}
        try:
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(done))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if not gone:
                        continue
                    try:  # a result written just before the exit may be in flight
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {gone[0]} ended with exit code "
                                           f"{procs[gone[0]].exitcode} and no result") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                done[rank] = pickle.loads(value)
        finally:
            _end(procs)
    return [done[r] for r in range(world_size)]


__all__ = ["run_ranks"]
