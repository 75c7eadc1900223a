"""The imperative collectives (port of
``paddle_tpu/distributed/collective.py``): Paddle's signatures and
in-place semantics on ``torch.distributed``.

A collective writes its result into the tensor (or appends to the list)
it was given and returns a task with ``wait()`` and ``is_completed()``;
``sync_op=False`` returns before the exchange ends. Ranks, ``src`` and
``dst`` are global ranks; a ``src`` outside the group is read as a group
rank, as the reference reads it. ``ReduceOp.AVG`` is a sum divided by the
group's size (gloo has no average), in the tensor's dtype, truncated for
integers as the reference's mean is when written back.

With no process group (world size 1, ``init_parallel_env`` made none)
every collective is the identity, as the reference's tier 4. With a
group, even of one rank, the call goes through ``torch.distributed``.
gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only: on a
gloo group any other collective given CUDA tensors copies them through
host memory and back, and counts the call in ``CommStats.host_staged``.
An NCCL group never stages.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as tdist

from .comm.stats import get_comm_stats
from .parallel_env import get_world_size, is_initialized


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


#: the reference's legacy integer enum (core.ReduceOp)
_LEGACY_OPS = {0: ReduceOp.SUM, 1: ReduceOp.MAX, 2: ReduceOp.MIN,
               3: ReduceOp.PROD, 4: ReduceOp.AVG}
_TORCH_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM,
              ReduceOp.MAX: tdist.ReduceOp.MAX,
              ReduceOp.MIN: tdist.ReduceOp.MIN,
              ReduceOp.PROD: tdist.ReduceOp.PRODUCT,
              ReduceOp.AVG: tdist.ReduceOp.SUM}


def _normalize_op(op):
    op = _LEGACY_OPS.get(op, op) if isinstance(op, int) else op
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown ReduceOp {op!r}")
    return op


class Group:
    """A communication group: its ranks (ascending, as torch numbers a
    group), the mesh axis it spans when the topology made it, and the
    torch ``ProcessGroup`` (None with no process group)."""

    _next_id = [0]

    def __init__(self, ranks=None, axis=None, name=None, pg=None):
        self.ranks = sorted(ranks) if ranks is not None else list(
            range(get_world_size()))
        self.axis = axis
        self.pg = pg
        Group._next_id[0] += 1
        self.id = Group._next_id[0]
        self.name = name or f"group_{self.id}"

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        """This rank's index within the group (-1 if not a member)."""
        return self.get_group_rank(tdist.get_rank() if is_initialized()
                                   else 0)

    def get_group_rank(self, global_rank):
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            return -1

    def is_member(self):
        return self.rank >= 0

    @property
    def process_ids(self):
        return self.ranks

    @property
    def backend(self):
        """``"nccl"`` or ``"gloo"``; None with no process group."""
        return None if self.pg is None else str(tdist.get_backend(self.pg))

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, axis={self.axis}, "
                f"backend={self.backend})")


_default = [None, None]      # [Group, the WORLD process group it wraps]


def _get_default_group() -> Group:
    world = tdist.group.WORLD if is_initialized() else None
    if _default[0] is None or _default[1] is not world:
        _default[0] = Group(list(range(get_world_size())), name="world",
                            pg=world)
        _default[1] = world
    return _default[0]


def new_group(ranks=None, backend=None, timeout=None):
    """A group of ``ranks`` (every rank, by default). Like torch's, every
    rank of the world calls it, in the same order."""
    if ranks is None:
        ranks = list(range(get_world_size()))
    if not is_initialized():
        return Group(ranks)
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=timeout)
    pg = tdist.new_group(sorted(ranks), timeout=timeout, backend=backend)
    return Group(ranks, pg=pg)


def get_group(gid=0):
    return _get_default_group()


def destroy_process_group(group=None):
    if group is None:
        if is_initialized():
            tdist.destroy_process_group()
        _default[0] = _default[1] = None
    elif group.pg is not None and group.is_member():
        tdist.destroy_process_group(group.pg)


class _Task:
    """A collective's handle: ``wait()`` ends the exchange (and writes a
    staged or averaged result back), ``is_completed()`` polls it."""

    def __init__(self, work=None, then=None):
        self._work = work
        self._then = then

    def wait(self, timeout=None):
        if self._work is not None:
            if timeout is None:
                self._work.wait()
            else:
                self._work.wait(datetime.timedelta(seconds=timeout))
            self._work = None
        if self._then is not None:
            then, self._then = self._then, None
            then()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _run(work, sync_op, then=None):
    task = _Task(work, then)
    if sync_op:
        task.wait()
    return task


def _idle(group):
    """True when this call is an identity or not this rank's: no process
    group, or a rank outside ``group``."""
    return group.pg is None or not group.is_member()


#: what gloo takes on CUDA tensors
_GLOO_CUDA = ("all_reduce", "broadcast")


def _staged(group, kind, *tensors):
    """Whether ``kind`` on ``group`` copies its tensors through host
    memory (counted): a gloo group and CUDA tensors, for a collective
    gloo runs on the CPU only."""
    if kind in _GLOO_CUDA or group.backend != "gloo":
        return False
    if any(t is not None and t.is_cuda for t in tensors):
        get_comm_stats().record_staged()
        return True
    return False


def _host(t, staged):
    return t.cpu() if staged and t is not None else t


def _record_comm(kind, nbytes, group):
    """CommStats for the dense collectives: one record a call on the
    issuing rank, wire == logical."""
    if group.nranks > 1:
        get_comm_stats().record(kind, logical_bytes=nbytes, wire_bytes=nbytes)


def _average(tensor, n):
    """``tensor`` (a sum over n ranks) divided by n in place: a true
    division by a tensor (a CUDA division by a Python number multiplies
    by its reciprocal), truncated for integers."""
    if n == 1:
        return
    if tensor.is_floating_point() or tensor.is_complex():
        tensor.div_(torch.full((), n, dtype=tensor.dtype,
                               device=tensor.device))
    else:
        tensor.copy_(torch.div(tensor, n, rounding_mode="trunc"))


def _src(group, src):
    """A global rank: ``src`` itself when it is one of the group's ranks,
    else its group rank read as the reference reads it."""
    return src if src in group.ranks else group.ranks[src]


def _bytes(t):
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    group = group or _get_default_group()
    if _idle(group):
        return _Task()
    op = _normalize_op(op)
    _record_comm("all_reduce", _bytes(tensor), group)
    work = tdist.all_reduce(tensor, _TORCH_OPS[op], group.pg, async_op=True)
    then = (lambda: _average(tensor, group.nranks)) if op == ReduceOp.AVG \
        else None
    return _run(work, sync_op, then)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's ``tensor`` to ``tensor_list``, in rank order."""
    group = group or _get_default_group()
    if group.pg is None:
        tensor_list.append(tensor.clone())
        return _Task()
    if not group.is_member():
        return _Task()
    _record_comm("all_gather", _bytes(tensor), group)
    return _all_gather(tensor_list, tensor, group, sync_op)


def _all_gather(tensor_list, tensor, group, sync_op):
    """``all_gather`` on a live group, unrecorded (the quantized
    exchange records its own wire)."""
    staged = _staged(group, "all_gather", tensor)
    src = _host(tensor.contiguous(), staged)
    outs = [torch.empty_like(src) for _ in range(group.nranks)]
    work = tdist.all_gather(outs, src, group.pg, async_op=True)

    def then():
        tensor_list.extend(o.to(tensor.device) if staged else o
                           for o in outs)
    return _run(work, sync_op, then)


def all_gather_object(object_list, obj, group=None):
    group = group or _get_default_group()
    if group.pg is None:
        object_list.append(obj)
        return
    if not group.is_member():
        return
    out = [None] * group.nranks
    tdist.all_gather_object(out, obj, group.pg)
    object_list.extend(out)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` gets the reduction over the ranks of their
    ``tensor_list[my group rank]``."""
    group = group or _get_default_group()
    if group.pg is None:
        tensor.copy_(tensor_list[0])
        return _Task()
    if not group.is_member():
        return _Task()
    op = _normalize_op(op)
    _record_comm("reduce_scatter", sum(_bytes(t) for t in tensor_list),
                 group)
    staged = _staged(group, "reduce_scatter", tensor, *tensor_list)
    out = _host(tensor, staged)
    ins = [_host(t.contiguous(), staged) for t in tensor_list]
    work = tdist.reduce_scatter(out, ins, _TORCH_OPS[op], group.pg,
                                async_op=True)

    def then():
        if op == ReduceOp.AVG:
            _average(out, group.nranks)
        if staged:
            tensor.copy_(out)
    return _run(work, sync_op, then)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank ``i`` receives every rank's ``in_tensor_list[i]``, appended to
    ``out_tensor_list`` in rank order (the tensors of one shape, as the
    reference stacks them)."""
    group = group or _get_default_group()
    if group.pg is None:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return _Task()
    if not group.is_member():
        return _Task()
    staged = _staged(group, "alltoall", *in_tensor_list)
    stacked = _host(torch.stack(list(in_tensor_list)), staged)
    out = torch.empty_like(stacked)
    work = tdist.all_to_all_single(out, stacked, group=group.pg,
                                   async_op=True)
    device = in_tensor_list[0].device

    def then():
        out_tensor_list.extend(t.to(device) if staged else t
                               for t in out.unbind(0))
    return _run(work, sync_op, then)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``in_tensor``'s rows split by ``in_split_sizes`` (equal parts by
    default) go one part a rank; ``out_tensor`` gets the parts sent to
    this rank, in rank order (resized to fit, as the reference rebinds
    it)."""
    group = group or _get_default_group()
    n = group.nranks
    if group.pg is None:
        out_tensor.resize_(in_tensor.shape).copy_(in_tensor)
        return _Task()
    if not group.is_member():
        return _Task()
    staged = _staged(group, "alltoall_single", in_tensor)
    src = _host(in_tensor.contiguous(), staged)
    if in_split_sizes is not None and out_split_sizes is None:
        # the sizes each peer sends here, exchanged first
        mine = torch.tensor(list(in_split_sizes), dtype=torch.int64,
                            device=src.device)
        theirs = torch.empty_like(mine)
        tdist.all_to_all_single(theirs, mine, group=group.pg)
        out_split_sizes = theirs.tolist()
    rows = sum(out_split_sizes) if out_split_sizes is not None else \
        src.shape[0] // n * n
    out = torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    work = tdist.all_to_all_single(
        out, src, None if out_split_sizes is None else list(out_split_sizes),
        None if in_split_sizes is None else list(in_split_sizes),
        group=group.pg, async_op=True)

    def then():
        out_tensor.resize_(out.shape).copy_(out)
    return _run(work, sync_op, then)


def broadcast(tensor, src, group=None, sync_op=True):
    group = group or _get_default_group()
    if _idle(group):
        return _Task()
    work = tdist.broadcast(tensor, _src(group, src), group.pg, async_op=True)
    return _run(work, sync_op)


def broadcast_object_list(object_list, src, group=None):
    """``object_list`` on every rank becomes ``src``'s, in place (the
    lists of one length on every rank, as torch's)."""
    group = group or _get_default_group()
    if _idle(group):
        return
    tdist.broadcast_object_list(object_list, _src(group, src), group.pg)


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """``dst``'s ``tensor`` gets the reduction; the others keep theirs."""
    group = group or _get_default_group()
    if _idle(group):
        return _Task()
    op = _normalize_op(op)
    dst = _src(group, dst)
    me = tdist.get_rank()
    staged = _staged(group, "reduce", tensor)
    buf = _host(tensor, staged) if staged else (
        tensor if me == dst else tensor.clone())
    work = tdist.reduce(buf, dst, _TORCH_OPS[op], group.pg, async_op=True)

    def then():
        if me == dst:
            if op == ReduceOp.AVG:
                _average(buf, group.nranks)
            if staged:
                tensor.copy_(buf)
    return _run(work, sync_op, then)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` gets ``src``'s ``tensor_list[my group rank]``."""
    group = group or _get_default_group()
    if group.pg is None:
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _Task()
    if not group.is_member():
        return _Task()
    src = _src(group, src)
    is_src = tdist.get_rank() == src
    staged = _staged(group, "scatter", tensor,
                     *(tensor_list if is_src else ()))
    out = _host(tensor, staged)
    ins = [_host(t.contiguous(), staged) for t in tensor_list] \
        if is_src else None
    work = tdist.scatter(out, ins, src, group.pg, async_op=True)
    return _run(work, sync_op, (lambda: tensor.copy_(out)) if staged
                else None)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` appended to ``dst``'s ``gather_list`` in
    rank order; the other ranks receive nothing."""
    group = group or _get_default_group()
    if group.pg is None:
        if gather_list is not None:
            gather_list.append(tensor.clone())
        return _Task()
    if not group.is_member():
        return _Task()
    dst = _src(group, dst)
    is_dst = tdist.get_rank() == dst
    staged = _staged(group, "gather", tensor)
    src = _host(tensor.contiguous(), staged)
    outs = [torch.empty_like(src) for _ in range(group.nranks)] \
        if is_dst else None
    work = tdist.gather(src, outs, dst, group.pg, async_op=True)

    def then():
        if is_dst and gather_list is not None:
            gather_list.extend(o.to(tensor.device) if staged else o
                               for o in outs)
    return _run(work, sync_op, then)


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """``src``'s ``in_object_list[my group rank]`` appended to
    ``out_object_list``."""
    group = group or _get_default_group()
    if group.pg is None:
        out_object_list.append(in_object_list[0])
        return
    if not group.is_member():
        return
    src = _src(group, src)
    out = [None]
    tdist.scatter_object_list(
        out, in_object_list if tdist.get_rank() == src else None, src,
        group.pg)
    out_object_list.append(out[0])


def barrier(group=None):
    group = group or _get_default_group()
    if _idle(group):
        return
    tdist.barrier(group.pg)


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------


def _p2p_group(group):
    group = group or _get_default_group()
    if group.pg is None or get_world_size() <= 1:
        raise RuntimeError("send/recv needs a process group of more than "
                           "one rank (init_parallel_env under a launcher, "
                           "or spawn)")
    return group


def send(tensor, dst=0, group=None, sync_op=True):
    group = _p2p_group(group)
    staged = _staged(group, "send", tensor)
    work = tdist.isend(_host(tensor.contiguous(), staged), dst, group.pg)
    return _run(work, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    group = _p2p_group(group)
    staged = _staged(group, "recv", tensor)
    buf = _host(tensor, staged)
    work = tdist.irecv(buf, src, group.pg)
    return _run(work, sync_op, (lambda: tensor.copy_(buf)) if staged
                else None)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One operation of :func:`batch_isend_irecv`: ``op`` is ``isend``,
    ``irecv``, ``send`` or ``recv``."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (send, isend, recv, irecv):
            raise ValueError(f"P2POp takes send, isend, recv or irecv, not "
                             f"{op!r}")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start every send, then every receive, without blocking (matched
    pairs cannot deadlock); returns their tasks. On NCCL the list goes to
    torch's ``batch_isend_irecv`` as one group of launches."""
    groups = {id(_p2p_group(p.group)): _p2p_group(p.group)
              for p in p2p_op_list}
    if all(g.backend == "nccl" for g in groups.values()):
        ops = [tdist.P2POp(tdist.isend if p.op in (send, isend)
                           else tdist.irecv, p.tensor, p.peer,
                           _p2p_group(p.group).pg) for p in p2p_op_list]
        return [_Task(w) for w in tdist.batch_isend_irecv(ops)]
    tasks = [isend(p.tensor, p.peer, p.group) for p in p2p_op_list
             if p.op in (send, isend)]
    tasks += [irecv(p.tensor, p.peer, p.group) for p in p2p_op_list
              if p.op in (recv, irecv)]
    return tasks


class stream:
    """``paddle.distributed.stream``: the same collectives."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    gather = staticmethod(gather)
    send = staticmethod(send)
    recv = staticmethod(recv)
