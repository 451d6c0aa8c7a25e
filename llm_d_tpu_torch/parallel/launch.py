"""Starting the ranks of a mesh: one process per rank, joined by
``torch.distributed`` at ``127.0.0.1:<free port>`` (rank 0 hosts the
store).

* :func:`start_ranks` starts ranks 1..N-1 as ``spawn`` processes running
  ``target(rank, world, address, *args)``; the caller is rank 0 (the
  server's entry point, ``server/openai.py``).
* :class:`RankPool` keeps N worker ranks alive and runs one function on
  all of them at a time (SPMD), each call with a deadline: a rank that
  misses it (say, hung in a collective) has the whole pool killed, and the
  next call starts a fresh one.  The CPU tests and the card smoke drive
  meshes through it.

A rank's process exits when its parent does (it polls the parent's pid
between tasks), so a killed caller leaves no rank behind.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

# How often an idle rank checks that its parent is alive.
PARENT_POLL_S = 2.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _context():
    import multiprocessing
    return multiprocessing.get_context("spawn")


def start_ranks(world: int, address: str, target: Callable, args=()
                ) -> List[Any]:
    """Start ranks 1..world-1 as processes running ``target(rank, world,
    address, *args)``; the caller joins as rank 0."""
    ctx = _context()
    procs = []
    for rank in range(1, world):
        p = ctx.Process(target=target, args=(rank, world, address) + tuple(
            args), name=f"llmd-rank{rank}", daemon=False)
        p.start()
        procs.append(p)
    return procs


def _worker(rank: int, world: int, address: str, device: str,
            threads: int, timeout_s: float, tasks, results) -> None:
    import torch
    from llm_d_tpu_torch.parallel.mesh import init_distributed
    from llm_d_tpu_torch.utils.device import resolve_device
    if threads:
        torch.set_num_threads(threads)
    parent = os.getppid()
    try:
        init_distributed(rank, world, address,
                         resolve_device(device, rank), timeout_s=timeout_s)
        results.put((rank, True, None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        try:
            task = tasks.get(timeout=PARENT_POLL_S)
        except queue.Empty:
            if os.getppid() != parent:
                return                     # the caller is gone
            continue
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist
    dist.destroy_process_group()


class RankPool:
    """``world`` worker ranks joined in one process group on ``device``
    ("cpu", or None for the rank's CUDA card), running one function at a
    time on every rank."""

    def __init__(self, world: int, device: Optional[str] = "cpu",
                 threads: int = 1, timeout_s: float = 120.0):
        self.world = world
        self.device = device
        self.threads = threads
        self.timeout_s = timeout_s
        self._procs: List[Any] = []

    def _start(self) -> None:
        ctx = _context()
        address = f"127.0.0.1:{free_port()}"
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, name=f"llmd-rank{r}", daemon=True,
                        args=(r, self.world, address, self.device,
                              self.threads, self.timeout_s, self._tasks[r],
                              self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect(self.timeout_s, "joining the process group")

    def _collect(self, timeout_s: float, what: str) -> List[Any]:
        out: List[Any] = [None] * self.world
        errors, pending = [], set(range(self.world))
        deadline = time.monotonic() + timeout_s
        while pending:
            # Short waits, so a rank that died is noticed at once.
            left = min(deadline - time.monotonic(), PARENT_POLL_S)
            try:
                rank, ok, value = self._results.get(timeout=max(left, 0.01))
            except queue.Empty:
                if time.monotonic() < deadline and all(
                        p.is_alive() for p in self._procs):
                    continue
                dead = [p.name for p in self._procs if not p.is_alive()]
                self.close(kill=True)
                raise TimeoutError(
                    f"ranks {sorted(pending)} missed the {timeout_s:.0f} s "
                    f"deadline {what}" + (f" (dead: {dead})" if dead else ""))
            pending.discard(rank)
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            # The others may hang in a collective the failed one left.
            self.close(kill=True)
            raise RuntimeError("\n".join(errors))
        return out

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None,
            **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; returns the results in
        rank order.  ``fn`` must be importable by name (module level)."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(timeout_s or self.timeout_s, fn.__name__)

    def close(self, kill: bool = False) -> None:
        procs = [p for p in self._procs if p.pid is not None]
        self._procs = []
        if not kill:
            for q in self._tasks if procs else ():
                q.put(None)
            for p in procs:
                p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)
