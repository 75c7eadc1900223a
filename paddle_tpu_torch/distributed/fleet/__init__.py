"""paddle.distributed.fleet (port of
``paddle_tpu/distributed/fleet/__init__.py``): the hybrid-parallel facade
in collective mode.

``init`` joins the process group (``init_parallel_env``), builds the
global mesh from the strategy's degrees and installs the hybrid
communicate group of per-axis groups, as the reference's ``init``
installs its mesh, hybrid group and strategy. ``distributed_model``
wraps a model for data parallelism (``DataParallel``) and
``distributed_optimizer`` an optimizer (``HybridParallelOptimizer``).

Tensor parallelism, sharding and the DGC / LocalSGD meta-optimizers come
with ROADMAP queue A item 8b; pipeline and sequence parallelism (a
``PipelineLayer``, ``pp_degree`` or ``sep_degree`` above 1) with 8c;
parameter-server mode and ``auto_search`` with 8d. Each raises
``NotImplementedError`` naming its item until then.
"""
from __future__ import annotations

import os

from .distributed_strategy import DistributedStrategy
from .hybrid_parallel_optimizer import HybridParallelOptimizer
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from .. import mesh as mesh_mod
from ..parallel import DataParallel
from ..parallel_env import get_rank, get_world_size, init_parallel_env

# the module-level fleet state (the reference's Fleet singleton)
_strategy: DistributedStrategy | None = None
_initialized = [False]


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO", backend=None):
    """Collective mode: join the world (``backend`` as
    ``init_parallel_env`` takes it), build the mesh from ``strategy``'s
    degrees and install the hybrid communicate group."""
    global _strategy
    if not is_collective or (role_maker is not None and
                             not getattr(role_maker, "_is_collective", True)):
        raise NotImplementedError(
            "parameter-server mode comes with ROADMAP queue A item 8d")
    strategy = strategy or DistributedStrategy()
    if getattr(strategy, "auto_search", False):
        raise NotImplementedError(
            "strategy.auto_search (the cost-model mesh search) comes with "
            "ROADMAP queue A item 8d")
    init_parallel_env(backend=backend)
    mesh_mod.init_mesh(strategy.degrees())
    _strategy = strategy
    set_hybrid_communicate_group(None)
    set_hybrid_communicate_group(HybridCommunicateGroup())
    _initialized[0] = True


def is_initialized():
    return _initialized[0]


def get_strategy() -> DistributedStrategy:
    return _strategy or DistributedStrategy()


def distributed_model(model):
    """Wrap per the strategy: dp above 1 gives a ``DataParallel``; the
    other axes raise until their items land."""
    d = get_strategy().degrees()
    if type(model).__name__ == "PipelineLayer" or d["pp"] > 1:
        raise NotImplementedError(
            "pipeline parallelism (PipelineLayer, pp_degree > 1) comes with "
            "ROADMAP queue A item 8c")
    if d["sep"] > 1:
        raise NotImplementedError(
            "sequence parallelism (sep_degree > 1) comes with ROADMAP queue "
            "A item 8c")
    if d["mp"] > 1 or d["sharding"] > 1:
        raise NotImplementedError(
            "tensor parallelism and sharding (mp_degree or sharding_degree "
            "> 1) come with ROADMAP queue A item 8b")
    if d["dp"] > 1:
        return DataParallel(
            model, group=get_hybrid_communicate_group()
            .get_data_parallel_group())
    return model


def distributed_optimizer(optimizer, strategy=None):
    strategy = strategy or get_strategy()
    if getattr(strategy, "dgc", False) or getattr(strategy, "localsgd",
                                                  False):
        raise NotImplementedError(
            "the DGC and LocalSGD meta-optimizers come with ROADMAP queue A "
            "item 8b")
    return HybridParallelOptimizer(optimizer, get_hybrid_communicate_group(),
                                   strategy)


# -- the worker helpers (Paddle's Fleet API) ---------------------------------
def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def is_first_worker():
    return get_rank() == 0


def worker_endpoints(to_string=False):
    from ..parallel_env import ParallelEnv
    eps = ParallelEnv().trainer_endpoints
    return ",".join(eps) if to_string else eps


def barrier_worker():
    from ..collective import barrier
    barrier()


# -- the collective role makers ----------------------------------------------
class UserDefinedRoleMaker:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective


class PaddleCloudRoleMaker:
    """Reads the PaddleCloud launch contract (``TRAINING_ROLE``,
    ``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``, ...)."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        env = os.environ
        self._role = env.get("TRAINING_ROLE", "TRAINER").upper()
        self._trainers = int(env.get("PADDLE_TRAINERS_NUM", "1"))
        self._trainer_id = int(env.get("PADDLE_TRAINER_ID", "0"))

    def is_worker(self):
        return self._role == "TRAINER"

    def is_server(self):
        return self._role == "PSERVER"

    def worker_index(self):
        return self._trainer_id

    def worker_num(self):
        return self._trainers
