"""The hybrid topology (port of
``paddle_tpu/distributed/fleet/topology.py``): ``CommunicateTopology``,
the rank arithmetic of an N-D mesh in Paddle's order ``[data, pipe,
sharding, sep, model]``, and ``HybridCommunicateGroup``, one process
group a parallel axis with the reference's getters.

With no topology given, the groups are the installed mesh's per-axis
groups (``DeviceMesh.get_group``); a topology given explicitly makes its
own with ``new_group``, every rank creating every axis's groups in the
same order, as Paddle's does.
"""
from __future__ import annotations

import itertools

import numpy as np

from .. import mesh as mesh_mod
from ..collective import Group, new_group
from ..parallel_env import get_rank, is_initialized


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or
                                    ["data", "pipe", "sharding", "sep",
                                     "model"])
        self._dims = list(dims or [1] * len(self._parallel_names))
        self._coord2rank = {}
        self._rank2coord = {}
        for rank, coord in enumerate(
                itertools.product(*[range(d) for d in self._dims])):
            self._coord2rank[coord] = rank
            self._rank2coord[rank] = coord

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for coord, r in self._coord2rank.items()
                      if coord[axis] == index)

    def get_comm_list(self, axis_name):
        """The rank lists of the communicators along ``axis_name``."""
        axis = self._parallel_names.index(axis_name)
        others = [range(d) for i, d in enumerate(self._dims) if i != axis]
        comm_list = []
        for fixed in itertools.product(*others):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(fixed)
                coord.insert(axis, i)
                ranks.append(self._coord2rank[tuple(coord)])
            comm_list.append(ranks)
        return comm_list


#: the reference's parallel names -> the mesh's axis names
_NAME2AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "sep": "sep", "model": "mp"}


def _mesh_group(m, axis, ranks, name):
    """The mesh's process group along ``axis``, checked against the
    topology's rank list."""
    pg = m.get_group(axis) if is_initialized() else None
    if pg is not None:
        import torch.distributed as tdist
        got = tdist.get_process_group_ranks(pg)
        if sorted(got) != sorted(ranks):
            raise RuntimeError(f"the mesh's {axis} group holds ranks {got}; "
                               f"the topology says {ranks}")
    return Group(ranks, axis=axis, name=name, pg=pg)


class HybridCommunicateGroup:
    """Per-axis groups and this rank's coordinates."""

    def __init__(self, topology: CommunicateTopology | None = None):
        from_mesh = topology is None
        if from_mesh:
            m = mesh_mod.get_mesh()
            dims = [mesh_mod.axis_size(ax) for ax in mesh_mod.HYBRID_AXES]
            topology = CommunicateTopology(dims=dims)
        self._topo = topology
        self.nranks = topology.world_size()
        self.global_rank = max(get_rank(), 0)
        names = self._topo.get_hybrid_group_names()
        self._coord = dict(zip(names, self._topo.get_coord(self.global_rank)))
        self._groups = {}
        for name in names:
            axis = _NAME2AXIS.get(name, name)
            for ranks in self._topo.get_comm_list(name):
                if from_mesh:
                    if self.global_rank in ranks:
                        self._groups[name] = _mesh_group(
                            m, axis, ranks, f"{name}_group")
                    continue
                # every rank makes every group, in one order
                g = new_group(ranks)
                if self.global_rank in ranks:
                    g.axis, g.name = axis, f"{name}_group"
                    self._groups[name] = g

    # -- degrees ---------------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._topo.get_dim("data")

    def get_model_parallel_world_size(self):
        return self._topo.get_dim("model")

    def get_pipe_parallel_world_size(self):
        return self._topo.get_dim("pipe")

    def get_sharding_parallel_world_size(self):
        return self._topo.get_dim("sharding")

    def get_sep_parallel_world_size(self):
        return self._topo.get_dim("sep")

    # -- this rank's coordinates -----------------------------------------------
    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_stage_id(self):
        return self._coord["pipe"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    # -- groups ----------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["data"]

    def get_model_parallel_group(self):
        return self._groups["model"]

    def get_pipe_parallel_group(self):
        return self._groups["pipe"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_check_parallel_group(self, *a, **k):
        from ..collective import _get_default_group
        return _get_default_group()

    def get_data_parallel_group_src_rank(self):
        return self._groups["data"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["model"].ranks[0]

    def get_p2p_groups(self):
        return None

    @property
    def topology(self):
        return self._topo


_hcg: HybridCommunicateGroup | None = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    global _hcg
    if _hcg is None:
        _hcg = HybridCommunicateGroup()
    return _hcg
