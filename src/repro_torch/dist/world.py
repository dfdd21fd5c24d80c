"""A world of ranks on one host: ``N`` processes of ``torch.distributed``
(no JAX counterpart: the JAX package backs its meshes with fake XLA
devices in one process).

    with World(8, backend="gloo", device="cpu") as w:
        results = w.run(fn, *args)   # fn(rank_ctx, *args) on every rank

``device`` None (the default) means the CUDA card; the CPU only when
asked for by name.

Ranks start with the ``spawn`` method (a parent that has touched CUDA
cannot fork) and meet through a ``FileStore`` in a fresh temporary
directory, so no port is fixed and any number of worlds can run side by
side. Each rank gets an explicit device (``dist.meshes.rank_devices``:
one card per rank for ``nccl``, the cards in turn for ``gloo``, which
stages CUDA tensors through host memory) and, on the CPU, one intra-op
thread. ``fn`` and its arguments travel by value (``pickle``), results
likewise; ``fn`` must be importable by its module path in the child.

A world runs any number of ``run`` calls. If a rank raises or dies, the
others may be blocked inside a collective: ``run`` then terminates every
rank and raises with each failed rank's traceback, and the world is
closed. Nothing falls back to fewer ranks.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank's function is told about itself."""

    rank: int
    world_size: int
    backend: str
    device: torch.device  # this rank's device


def _rank_main(rank, world_size, backend, device, store, tasks, results):
    import torch.distributed as dist

    from repro_torch.dist.meshes import rank_devices

    dev = rank_devices(backend, world_size, device)[rank]
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world_size, rank=rank)
    ctx = RankContext(rank, world_size, backend, dev)
    try:
        while True:
            msg = tasks.get()
            if msg is None:
                break
            try:
                fn, args = pickle.loads(msg)
                results.put((rank, True, pickle.dumps(fn(ctx, *args))))
            except BaseException:  # reported to the parent, which stops the world
                results.put((rank, False, traceback.format_exc()))
                raise
    finally:
        dist.destroy_process_group()


class World:
    """``nprocs`` ranks of one ``torch.distributed`` world (see the module
    docstring). ``timeout`` bounds each ``run`` in seconds."""

    def __init__(self, nprocs: int, *, backend: str = "gloo", device=None,
                 timeout: float = 600.0):
        from repro_torch.device import resolve_device
        from repro_torch.dist.meshes import rank_devices

        self.nprocs, self.backend = nprocs, backend
        self.device = resolve_device(device)
        self.timeout = timeout
        rank_devices(backend, nprocs, self.device)  # refuses a route it cannot run
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="fedfog_world_")
        store = os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(nprocs)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, nprocs, backend, str(self.device), store,
                              self._tasks[r], self._results))
            for r in range(nprocs)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        """``fn(ctx, *args)`` on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        msg = pickle.dumps((fn, args))
        for q in self._tasks:
            q.put(msg)
        out, failed = [None] * self.nprocs, {}
        pending = set(range(self.nprocs))
        deadline = time.monotonic() + self.timeout
        while pending:
            try:
                rank, ok, payload = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead:
                    failed.update({r: f"rank {r} exited with code "
                                      f"{self._procs[r].exitcode}" for r in dead})
                    break
                if time.monotonic() > deadline:
                    failed.update({r: f"rank {r} timed out after {self.timeout} s"
                                   for r in pending})
                    break
                continue
            pending.discard(rank)
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                failed[rank] = payload
                break
        if failed:
            self.close(force=True)
            raise RuntimeError("distributed run failed:\n" + "\n".join(
                f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
        return out

    def close(self, force: bool = False) -> None:
        """Stop every rank (``force``: without waiting for them) and remove
        the rendezvous directory."""
        if not force:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=60)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def spawn(fn, nprocs: int, *args, backend: str = "gloo", device=None,
          timeout: float = 600.0) -> list:
    """One ``run`` of ``fn(ctx, *args)`` on a fresh world of ``nprocs``
    ranks; the results in rank order."""
    with World(nprocs, backend=backend, device=device, timeout=timeout) as w:
        return w.run(fn, *args)
