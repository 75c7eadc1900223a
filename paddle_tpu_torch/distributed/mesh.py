"""The global hybrid mesh (port of ``paddle_tpu/distributed/mesh.py``):
the ranks in Paddle's axis order ``[dp, pp, sharding, sep, mp]`` (mp
innermost, dp outermost) as a ``torch.distributed.DeviceMesh``, whose
per-axis process groups ``fleet``'s topology hands out.

``init_mesh`` keeps the reference's rules: unspecified axes are 1, a
``dp`` of None or -1 takes the ranks left over, and the degrees must use
every rank. A rank is a process (one device under NCCL), where the
reference's mesh holds the devices of one controller (ROADMAP C51); the
multi-slice ordering of TPU pods has no counterpart, the launcher
numbering ranks node by node. With no process group (one rank) the mesh
is a :class:`LocalMesh` of one rank and no groups.

The sharding helpers (``sharding``, ``replicated``, ``batch_spec``,
``unshard_for_compute``, ``strip_axis``) become DTensor placements with
tensor parallelism and sharding (ROADMAP queue A item 8b); until then
they raise.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as tdist

from .parallel_env import get_world_size, is_initialized

#: Paddle's hybrid axis order
HYBRID_AXES = ("dp", "pp", "sharding", "sep", "mp")

_global_mesh = None


class LocalMesh:
    """The mesh of a world of one with no process group: every axis of
    size 1, this rank at coordinate 0, no groups."""

    def __init__(self, sizes, names=HYBRID_AXES):
        self.shape = tuple(sizes)
        self.mesh_dim_names = tuple(names)

    def get_local_rank(self, mesh_dim=None):
        return 0

    def get_group(self, mesh_dim=None):
        return None


def init_mesh(degrees=None):
    """Build and install the global mesh from parallelism degrees
    (axis name -> size). With none: a 1-D dp mesh over every rank. Its
    device type is ``"cuda"`` under NCCL, else ``"cpu"``."""
    global _global_mesh
    n = get_world_size()
    degrees = dict(degrees or {})
    sizes = [int(degrees.get(ax, 1)) for ax in HYBRID_AXES]
    prod = int(np.prod([s for s in sizes if s > 0]))
    if n % max(prod, 1) != 0:
        raise ValueError(f"world size {n} not divisible by degree product "
                         f"{prod} ({dict(zip(HYBRID_AXES, sizes))})")
    if degrees.get("dp") in (None, -1):
        sizes[0] = n // (prod // max(sizes[0], 1)) if sizes[0] > 0 \
            else n // prod
    prod = int(np.prod(sizes))
    if prod != n:
        raise ValueError(f"degrees {dict(zip(HYBRID_AXES, sizes))} use {prod} "
                         f"ranks, but {n} are available")
    if not is_initialized():
        _global_mesh = LocalMesh(sizes)
        return _global_mesh
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if str(tdist.get_backend()) == "nccl" else "cpu"
    _global_mesh = init_device_mesh(device_type, tuple(sizes),
                                    mesh_dim_names=HYBRID_AXES)
    return _global_mesh


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def get_mesh():
    if _global_mesh is None:
        init_mesh()
    return _global_mesh


def has_mesh() -> bool:
    return _global_mesh is not None


def reset_mesh():
    global _global_mesh
    _global_mesh = None


def axis_size(name: str) -> int:
    m = get_mesh()
    names = m.mesh_dim_names or ()
    return int(m.shape[names.index(name)]) if name in names else 1


def axis_index(name: str) -> int:
    """This rank's coordinate along a mesh axis (the reference's is the
    trace-time index inside ``shard_map``)."""
    m = get_mesh()
    return int(m.get_local_rank(name)) if name in (m.mesh_dim_names or ()) \
        else 0


def _item_8b(what):
    raise NotImplementedError(
        f"{what} becomes a DTensor placement with tensor parallelism and "
        f"sharding, ROADMAP queue A item 8b")


def sharding(*spec):
    _item_8b("mesh.sharding")


def replicated():
    _item_8b("mesh.replicated")


def batch_spec(ndim: int = 3):
    _item_8b("mesh.batch_spec")


def strip_axis(spec, axis: str):
    _item_8b("mesh.strip_axis")


def unshard_for_compute(arrs, specs, fsdp_axis="sharding"):
    _item_8b("mesh.unshard_for_compute")
