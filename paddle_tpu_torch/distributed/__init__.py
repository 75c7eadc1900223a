"""paddle.distributed (port of ``paddle_tpu/distributed/__init__.py``) on
``torch.distributed``: one process a rank, NCCL on the card, gloo where
asked (the CPU).

* ``parallel_env``: ``init_parallel_env`` (a store or the launcher's
  variables), ranks and world size; ``spawn`` starts a world of local
  processes;
* ``collective``: Paddle's collectives, point to point and ``stream``,
  in place, with tasks;
* ``mesh``: the ``[dp, pp, sharding, sep, mp]`` DeviceMesh; ``fleet``:
  ``init``, the strategy, the hybrid communicate group,
  ``distributed_model`` and ``distributed_optimizer``;
* ``comm``: the bucketed, optionally quantized gradient exchange;
  ``DataParallel`` runs it during backward.

This is ROADMAP queue A item 8a. Tensor parallelism and sharding (8b),
pipeline and sequence parallelism (8c), and checkpointing, launch,
elastic, parameter servers and auto-parallel (8d) come later.
"""
from __future__ import annotations

import torch.distributed as _tdist

from .parallel_env import (  # noqa: F401
    init_parallel_env, get_rank, get_world_size, is_initialized, ParallelEnv,
)
from .collective import (  # noqa: F401
    ReduceOp, Group, new_group, get_group, destroy_process_group,
    all_reduce, all_gather, all_gather_object, reduce_scatter,
    alltoall, alltoall_single, broadcast, broadcast_object_list,
    reduce, scatter, gather, scatter_object_list, barrier,
    send, recv, isend, irecv, P2POp, batch_isend_irecv, stream,
)
from .parallel import DataParallel  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import mesh  # noqa: F401
from .mesh import init_mesh, get_mesh, HYBRID_AXES  # noqa: F401
from . import fleet  # noqa: F401
from . import collective as communication  # noqa: F401
from . import comm  # noqa: F401
from .comm import (  # noqa: F401
    GradientBucketer, all_reduce_quantized, reduce_scatter_quantized,
    get_comm_stats, reset_comm_stats,
)


def get_backend(group=None):
    """The process group's backend, ``"nccl"`` or ``"gloo"`` (the
    reference's is ``"xla"``); None with no process group."""
    if not is_initialized():
        return None
    return str(_tdist.get_backend(None if group is None else group.pg))


def is_available():
    return _tdist.is_available()
