"""Process bootstrap (port of ``paddle_tpu/distributed/parallel_env.py``:
``init_parallel_env``, ``get_rank``, ``get_world_size``,
``ParallelEnv``) on ``torch.distributed``.

The reference runs ranks as threads of one JAX process or one process a
host; the port runs one process a rank (ROADMAP C51). The rendezvous is
``torch.distributed.init_process_group``: from a given store (``spawn``
passes a ``FileStore``), else from the launcher's variables, read as the
reference reads them: torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or Paddle's
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_TRAINER_ENDPOINTS`` (the first endpoint hosts the store). At
world size 1 with no launcher it creates no group, and the collectives
are identities (the reference's tier 4).

The backend defaults to NCCL, which needs CUDA: without it
``init_parallel_env`` raises unless given ``backend="gloo"``, as every
entry point of the port refuses the CPU unasked.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as tdist

#: seconds a rendezvous or a collective may wait for its peers
DEFAULT_TIMEOUT_S = 300


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _launcher():
    """``(rank, world, init_method)`` from the launcher's variables, or
    None when none are set."""
    env = os.environ
    if "WORLD_SIZE" in env:
        return _env_int("RANK", 0), _env_int("WORLD_SIZE", 1), "env://"
    if "PADDLE_TRAINERS_NUM" in env:
        endpoints = env.get("PADDLE_TRAINER_ENDPOINTS", "")
        first = endpoints.split(",")[0] if endpoints else ""
        return (_env_int("PADDLE_TRAINER_ID", 0),
                _env_int("PADDLE_TRAINERS_NUM", 1),
                f"tcp://{first}" if first else None)
    return None


def default_backend(backend=None):
    """``backend``, or NCCL; NCCL (given or not) raises ``RuntimeError``
    on a machine without CUDA."""
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "NCCL needs CUDA, which is not available: pass backend='gloo' "
            "to run the ranks on the CPU")
    return backend


def init_parallel_env(backend=None, store=None, timeout_s=DEFAULT_TIMEOUT_S,
                      rank=None, world_size=None):
    """Join the process group (a no-op once joined). ``store`` with
    ``rank`` and ``world_size`` (``spawn`` passes them) or the
    launcher's variables name the world; with neither and a world of
    one, no group is made. With NCCL the process binds to CUDA device
    ``LOCAL_RANK``. Returns a :class:`ParallelEnv`."""
    if tdist.is_initialized():
        return ParallelEnv()
    backend = default_backend(backend)
    launcher = _launcher()
    if store is None and launcher is None:
        return ParallelEnv()
    if store is None:
        rank, world_size, init_method = launcher
        kw = dict(init_method=init_method)
    else:
        if rank is None or world_size is None:
            raise ValueError("a store needs rank and world_size")
        kw = dict(store=store)
    if store is None and world_size == 1 and init_method is None:
        return ParallelEnv()
    if backend == "nccl":
        dev = ParallelEnv().device_id
        if dev >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {dev} names no CUDA device "
                f"({torch.cuda.device_count()} present): NCCL takes one "
                f"device a rank")
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, rank=rank, world_size=world_size,
                             timeout=datetime.timedelta(seconds=timeout_s),
                             **kw)
    return ParallelEnv()


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank: in ``group`` (-1 outside it), else global;
    0 with no process group."""
    if group is not None:
        return group.rank
    return tdist.get_rank() if is_initialized() else 0


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return tdist.get_world_size() if is_initialized() else 1


class ParallelEnv:
    """paddle.distributed.ParallelEnv: the rank, world and device view."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        return _env_int("LOCAL_RANK", get_rank())

    @property
    def device_id(self):
        return _env_int("LOCAL_RANK", 0)

    dev_id = device_id

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]
