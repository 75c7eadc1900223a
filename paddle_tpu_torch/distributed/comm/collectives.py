"""Quantized collectives (port of
``paddle_tpu/distributed/comm/collectives.py``): blockwise-int8 or bf16
all-reduce and reduce-scatter.

Each rank encodes its contribution (int8 codes and fp32 block scales, or
bf16), the group all-gathers the encoded tensors, and every rank decodes
and reduces them locally in rank order: the reference exchanges the same
payloads through its rendezvous and reduces them the same way, so the
results agree bit for bit. The wire volume recorded is this rank's
payload. At a group of one the rank's own decoded contribution is the
result, with no exchange, as the reference's.

Error feedback: pass ``residual`` (an fp32 tensor of the vector's size,
updated in place) and each round's compression error joins the next
round's input instead of being lost.

``start_*`` launch the exchange without waiting and return a handle
whose ``wait()`` gives the result (the ready-bucket scheduler dispatches
a bucket this way during backward).
"""
from __future__ import annotations

import torch

from .. import collective as _collective
from .quantization import DEFAULT_BLOCK_SIZE, decode_wire, encode_wire
from .stats import get_comm_stats

PASSTHROUGH = (None, "", "none", "fp32")


def _postreduce(vals, op, n):
    """The reduction of the decoded contributions (an iterable, consumed
    one at a time), in rank order: the reference's ``np.sum(axis=0)``, one
    running sum; AVG divides it by ``n``."""
    op = _collective._normalize_op(op)
    R = _collective.ReduceOp
    acc = None
    for v in vals:
        if acc is None:
            acc = v.clone()
        elif op in (R.SUM, R.AVG):
            acc += v
        elif op == R.MAX:
            torch.maximum(acc, v, out=acc)
        elif op == R.MIN:
            torch.minimum(acc, v, out=acc)
        else:
            acc *= v
    if op == R.AVG and n > 1:
        acc /= torch.full((), float(n), device=acc.device)
    return acc


class _Pending:
    """An exchange in flight: ``wait()`` gathers the payloads, decodes
    and reduces them, and returns the fp32 result."""

    def __init__(self, tasks, finish):
        self._tasks, self._finish, self._out = tasks, finish, None

    def wait(self, timeout=None):
        if self._finish is not None:
            for t in self._tasks:
                t.wait(timeout)
            self._out, self._finish = self._finish(), None
        return self._out


def _encode(send, scheme, block_size, residual, kind, logical_bytes,
            keep_decoded):
    """Encode ``send``; record the call with its largest error; update
    ``residual``. Returns the payload, and this rank's decoded
    contribution when ``keep_decoded`` (else None: its buffer held the
    error)."""
    payload, wire = encode_wire(send, scheme, block_size)
    decoded = decode_wire(payload, send.numel(), block_size)
    error = send - decoded if keep_decoded else decoded.neg_().add_(send)
    err = 0.0
    if send.numel():
        lo, hi = error.aminmax()
        err = max(-float(lo), float(hi))
    if residual is not None:
        residual.copy_(error)
    get_comm_stats().record(kind, logical_bytes=logical_bytes,
                            wire_bytes=wire, max_error=err)
    return payload, decoded if keep_decoded else None


def _gather_payloads(payload, group):
    """Start all-gathers of the payload's tensors; returns the tasks and
    the per-tensor lists they fill (rank order)."""
    lists = [[] for _ in payload[1:]]
    tasks = [_collective._all_gather(out, t, group, sync_op=False)
             for out, t in zip(lists, payload[1:])]
    return tasks, lists


def _decoded_peers(payload, lists, n, numel, block_size):
    """Each rank's decoded contribution in rank order, decoded as it is
    reduced (its gathered tensors released after)."""
    for i in range(n):
        parts = tuple(lst[i] for lst in lists)
        for lst in lists:
            lst[i] = None
        yield decode_wire((payload[0],) + parts, numel, block_size)


def start_allreduce_array(flat, group=None, op=None, scheme="int8",
                          block_size: int = DEFAULT_BLOCK_SIZE,
                          residual=None, kind="all_reduce_q"):
    """Launch the all-reduce of a vector with a compressed wire format;
    the handle's ``wait()`` returns the fp32 result."""
    group = group or _collective._get_default_group()
    op = op if op is not None else _collective.ReduceOp.SUM
    n = group.nranks
    flat = flat.reshape(-1).to(torch.float32)
    numel = flat.numel()
    send = flat if residual is None else flat + residual
    alone = n == 1 or group.pg is None
    payload, decoded = _encode(send, scheme, block_size, residual, kind,
                               4 * numel, keep_decoded=alone)
    del flat, send
    if alone:
        return _Pending([], lambda: _postreduce([decoded], op, 1))
    tasks, lists = _gather_payloads(payload, group)
    return _Pending(tasks, lambda: _postreduce(_decoded_peers(
        payload, lists, n, numel, block_size), op, n))


def allreduce_array(flat, group=None, op=None, scheme="int8",
                    block_size: int = DEFAULT_BLOCK_SIZE, residual=None,
                    kind="all_reduce_q"):
    """All-reduce a vector with a compressed wire format; returns the
    fp32 result."""
    return start_allreduce_array(flat, group, op, scheme, block_size,
                                 residual, kind).wait()


def reduce_scatter_array(stacked, group=None, op=None, scheme="int8",
                         block_size: int = DEFAULT_BLOCK_SIZE,
                         residual=None, kind="reduce_scatter_q"):
    """Reduce-scatter with a compressed wire format. ``stacked``: this
    rank's ``[nranks, ...]`` contributions, slot ``i`` for group rank
    ``i``. Returns this rank's reduced fp32 slice."""
    group = group or _collective._get_default_group()
    op = op if op is not None else _collective.ReduceOp.SUM
    n = group.nranks
    stacked = torch.as_tensor(stacked).to(torch.float32)
    send = stacked if residual is None else stacked + residual.reshape(
        stacked.shape)
    flat = send.reshape(-1)
    alone = n == 1 or group.pg is None
    payload, decoded = _encode(flat, scheme, block_size, residual, kind,
                               4 * stacked.numel(), keep_decoded=alone)
    if alone:
        return _postreduce([decoded.reshape(stacked.shape)[0]], op, 1)
    tasks, lists = _gather_payloads(payload, group)
    for t in tasks:
        t.wait()
    mine = group.rank
    slices = (v.reshape(stacked.shape)[mine] for v in _decoded_peers(
        payload, lists, n, flat.numel(), block_size))
    return _postreduce(slices, op, n)


# ---------------------------------------------------------------------------
# the tensor-level API (Paddle's semantics: in place, a task returned)
# ---------------------------------------------------------------------------


def all_reduce_quantized(tensor, op=None, group=None, scheme="int8",
                         block_size: int = DEFAULT_BLOCK_SIZE, residual=None,
                         sync_op=True):
    """``all_reduce`` with a blockwise-quantized wire format: ``scheme``
    is ``"int8"``, ``"bf16"``, or None / ``"fp32"`` for the plain dense
    all-reduce. ``residual`` (fp32, the tensor's size) turns on error
    feedback."""
    if scheme in PASSTHROUGH:
        return _collective.all_reduce(
            tensor, op=op if op is not None else _collective.ReduceOp.SUM,
            group=group)
    red = allreduce_array(tensor, group=group, op=op, scheme=scheme,
                          block_size=block_size, residual=residual)
    tensor.copy_(red.view(tensor.shape))
    return _collective._Task()


def reduce_scatter_quantized(tensor, tensor_list, op=None, group=None,
                             scheme="int8",
                             block_size: int = DEFAULT_BLOCK_SIZE,
                             residual=None, sync_op=True):
    """``reduce_scatter`` with a blockwise-quantized wire format."""
    if scheme in PASSTHROUGH:
        return _collective.reduce_scatter(
            tensor, tensor_list,
            op=op if op is not None else _collective.ReduceOp.SUM,
            group=group)
    shard = reduce_scatter_array(torch.stack(list(tensor_list)), group=group,
                                 op=op, scheme=scheme, block_size=block_size,
                                 residual=residual)
    tensor.copy_(shard.view(tensor.shape))
    return _collective._Task()
