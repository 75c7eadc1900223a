"""paddle.distributed.spawn (port of ``paddle_tpu/distributed/spawn.py``):
one process a rank, started with ``torch.multiprocessing``'s ``"spawn"``
method (never ``fork``: the parent may hold CUDA or other threads).

Each child sets the launcher's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``), joins the
process group through a ``FileStore`` (``init_parallel_env``), runs
``func(*args)`` and sends its result back. The reference runs ranks as
threads and takes closures; here ``func`` must be picklable, a function
at a module's top level, and its module is imported by every child
(ROADMAP C51). The results come back in rank order as ``.results``.

Every world ends in bounded time: a rank that raises, dies or passes the
deadline (``timeout_s``) kills every child, and the parent raises with
that rank's traceback (or the ranks still running). The store's file
lives in a fresh directory under ``TMPDIR`` and is removed with it.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from .parallel_env import DEFAULT_TIMEOUT_S


class RankError(RuntimeError):
    """A rank of a spawned world raised, died or hung."""


def _child(rank, nprocs, func, args, backend, store_path, timeout_s, env,
           results):
    try:
        os.environ.update({k: str(v) for k, v in (env or {}).items()})
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                          LOCAL_RANK=str(rank), PADDLE_TRAINER_ID=str(rank),
                          PADDLE_TRAINERS_NUM=str(nprocs))
        import torch.distributed as tdist
        from .parallel_env import init_parallel_env
        store = tdist.FileStore(store_path, nprocs)
        init_parallel_env(backend=backend, store=store, timeout_s=timeout_s,
                          rank=rank, world_size=nprocs)
        out = func(*args)
        results.put((rank, "ok", out))
        from .collective import destroy_process_group
        destroy_process_group()
    except Exception:              # the rank's boundary: reported to the parent
        results.put((rank, "error", traceback.format_exc()))


class _Context:
    def __init__(self, procs, results, nprocs, deadline, store_dir):
        self.processes = procs
        self._results = results
        self._nprocs = nprocs
        self._deadline = deadline
        self._store_dir = store_dir
        self.results = None

    def _kill(self):
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join(10)
        shutil.rmtree(self._store_dir, ignore_errors=True)

    def join(self):
        """Wait for every rank; raises :class:`RankError` as soon as one
        fails, and at the deadline."""
        if self.results is not None:
            return True
        got = {}
        try:
            while len(got) < self._nprocs:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(self._nprocs)) - set(got))
                    raise RankError(f"ranks {missing} of {self._nprocs} did "
                                    f"not finish before the deadline")
                try:
                    rank, status, value = self._results.get(
                        timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.processes)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RankError(
                            f"rank {dead[0]} exited with code "
                            f"{self.processes[dead[0]].exitcode} before "
                            f"reporting")
                    continue
                if status == "error":
                    raise RankError(f"rank {rank} raised:\n{value}")
                got[rank] = value
            for p in self.processes:
                p.join(max(1.0, self._deadline - time.monotonic()))
        finally:
            self._kill()
        self.results = [got[r] for r in range(self._nprocs)]
        return True


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, *,
          backend=None, timeout_s=DEFAULT_TIMEOUT_S, env=None):
    """Run ``func(*args)`` on ``nprocs`` ranks (-1: one a CUDA device) in
    a world on ``backend`` (NCCL by default; ``"gloo"`` on the CPU).
    ``env`` adds variables to every child's environment. Returns a context
    whose ``.results`` lists the ranks' return values; with
    ``join=False`` call its ``join()``."""
    if nprocs in (-1, None):
        nprocs = torch.cuda.device_count() or 1
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="paddle_spawn_")
    store_path = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_child, args=(
        r, nprocs, func, args, backend, store_path, timeout_s, env, results),
        daemon=daemon) for r in range(nprocs)]
    for p in procs:
        p.start()
    context = _Context(procs, results, nprocs,
                       time.monotonic() + timeout_s, store_dir)
    if join:
        context.join()
    return context
