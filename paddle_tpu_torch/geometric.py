"""``paddle.geometric`` (port of ``paddle_tpu/geometric.py``): the segment
pools and the message-passing ops of graph learning.

Every op is a gather (``index_select``) and one scatter over the
destination ids: ``index_add`` for sums and means, ``scatter_reduce``
(``amax`` / ``amin``, ``include_self=False`` into zeros) for max and min,
so an empty segment reads 0 under every reduction, as the reference's
count mask gives. Autograd splits a max's or min's gradient evenly among
tied messages, as JAX's segment max and min do. On the card the sums are
atomic adds, in no fixed order. The results follow the inputs' device;
ids given as numpy or lists land on the data's device. With ``out_size``
/ ``num_segments`` given nothing reads the ids on the host.
"""
from __future__ import annotations

import torch

from .ops._util import as_tensor

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "send_u_recv", "send_ue_recv", "send_uv"]


def _ids(ids, like):
    return as_tensor(ids, like).to(device=like.device, dtype=torch.long)


def _n_segments(ids, out_size):
    """``out_size``, or the largest id + 1 (read on the host; 0 for no
    ids)."""
    if out_size is not None:
        return int(out_size)
    return int(ids.max()) + 1 if ids.numel() else 0


def _segment(x, segment_ids, num_segments, op):
    data = as_tensor(x)
    ids = _ids(segment_ids, data)
    return _segment_raw(data, ids, _n_segments(ids, num_segments), op)


# num_segments is the reference's extension over Paddle's signature: the
# row count is the largest id + 1 unless given


def segment_sum(data, segment_ids, num_segments=None, name=None):
    return _segment(data, segment_ids, num_segments, "sum")


def segment_mean(data, segment_ids, num_segments=None, name=None):
    return _segment(data, segment_ids, num_segments, "mean")


def segment_max(data, segment_ids, num_segments=None, name=None):
    return _segment(data, segment_ids, num_segments, "max")


def segment_min(data, segment_ids, num_segments=None, name=None):
    return _segment(data, segment_ids, num_segments, "min")


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather source-node features along edges, reduce at destinations.
    The output has ``x.shape[0]`` rows unless ``out_size`` is given, so a
    node without incoming edges keeps a zero row."""
    x = as_tensor(x)
    num = x.shape[0] if out_size is None else int(out_size)
    msgs = x.index_select(0, _ids(src_index, x))
    return _segment_raw(msgs, _ids(dst_index, x), num, reduce_op)


def _message(u, v, message_op):
    if message_op == "add":
        return u + v
    if message_op == "sub":
        return u - v
    if message_op == "mul":
        return u * v
    if message_op == "div":
        return u / v
    raise ValueError(message_op)


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Combine source-node features with edge features (``message_op``:
    add, sub, mul, div), reduce at destinations; ``x.shape[0]`` rows
    unless ``out_size`` is given."""
    x = as_tensor(x)
    y = as_tensor(y, x)
    num = x.shape[0] if out_size is None else int(out_size)
    msgs = _message(x.index_select(0, _ids(src_index, x)), y, message_op)
    return _segment_raw(msgs, _ids(dst_index, x), num, reduce_op)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message from source and destination node features."""
    x = as_tensor(x)
    y = as_tensor(y, x)
    return _message(x.index_select(0, _ids(src_index, x)),
                    y.index_select(0, _ids(dst_index, x)), message_op)


def _segment_raw(msgs, dst, num, reduce_op):
    """Reduce ``msgs`` rows into ``num`` segments by ``dst`` (int64 ids on
    the messages' device)."""
    out = msgs.new_zeros((num,) + tuple(msgs.shape[1:]))
    if reduce_op == "sum":
        return out.index_add(0, dst, msgs)
    if reduce_op == "mean":
        s = out.index_add(0, dst, msgs)
        cnt = torch.zeros(num, dtype=torch.float32, device=msgs.device)
        cnt = cnt.index_add(0, dst, torch.ones_like(dst, dtype=torch.float32))
        cnt = cnt.clamp_min(1.0).to(msgs.dtype)
        return s / cnt.reshape((num,) + (1,) * (msgs.ndim - 1))
    if reduce_op in ("max", "min"):
        idx = dst.reshape((-1,) + (1,) * (msgs.ndim - 1)).expand_as(msgs)
        return out.scatter_reduce(0, idx, msgs, "amax" if reduce_op == "max"
                                  else "amin", include_self=False)
    raise ValueError(reduce_op)
