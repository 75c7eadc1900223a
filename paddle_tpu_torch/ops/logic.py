"""Comparison, logical and bitwise ops, search and sort (the port of
``paddle_tpu/ops/logic.py``). Index outputs are int64 where the reference
narrows them to int32 (ROADMAP C26)."""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as dtypes
from ._util import as_tensor, binary

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "is_empty",
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "searchsorted", "bucketize"]


def _binop(name, fn):
    def op(x, y):
        return binary(fn, x, y)
    op.__name__ = op.__qualname__ = name
    return op


equal = _binop("equal", torch.eq)
not_equal = _binop("not_equal", torch.ne)
greater_than = _binop("greater_than", torch.gt)
greater_equal = _binop("greater_equal", torch.ge)
less_than = _binop("less_than", torch.lt)
less_equal = _binop("less_equal", torch.le)
logical_and = _binop("logical_and", torch.logical_and)
logical_or = _binop("logical_or", torch.logical_or)
logical_xor = _binop("logical_xor", torch.logical_xor)
bitwise_and = _binop("bitwise_and", torch.bitwise_and)
bitwise_or = _binop("bitwise_or", torch.bitwise_or)
bitwise_xor = _binop("bitwise_xor", torch.bitwise_xor)


def logical_not(x):
    return torch.logical_not(as_tensor(x))


def bitwise_not(x):
    return torch.bitwise_not(as_tensor(x))


def is_empty(x):
    x = as_tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


# -- search / sort ----------------------------------------------------------

def _arg_extreme(fn, x, axis, keepdim, dtype):
    x = as_tensor(x)
    if axis is None:
        out = fn(x.reshape(-1), 0)
    else:
        out = fn(x, int(axis), keepdim=keepdim)
    return out.to(dtypes.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg_extreme(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg_extreme(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=True):
    return torch.argsort(as_tensor(x), dim=axis, descending=descending,
                         stable=True)


def sort(x, axis=-1, descending=False, stable=True):
    return torch.sort(as_tensor(x), dim=axis, descending=descending,
                      stable=True).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    x = as_tensor(x)
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    ax = x.ndim - 1 if axis is None else axis % x.ndim
    v, i = torch.topk(x, int(k), dim=ax, largest=largest, sorted=sorted)
    return v, i


def kthvalue(x, k, axis=-1, keepdim=False):
    """The k-th smallest along ``axis`` and its index in a stable sort (the
    first of equal values), as the reference's sort-and-take."""
    x = as_tensor(x)
    v, i = torch.sort(x, dim=axis, stable=True)
    v, i = v.select(axis, k - 1), i.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


def mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis``: of the values with the most
    occurrences, the one met first, and the index where it is first met
    (the reference's counting rule, not ``torch.mode``'s smallest
    value)."""
    x = as_tensor(x)
    ax = axis % x.ndim
    moved = x.movedim(ax, -1)
    counts = (moved[..., :, None] == moved[..., None, :]).sum(-1)
    idx = torch.argmax(counts, dim=-1)
    vals = torch.take_along_dim(moved, idx[..., None], dim=-1)[..., 0]
    if keepdim:
        vals, idx = vals.unsqueeze(ax), idx.unsqueeze(ax)
    return vals, idx


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    ss, v = as_tensor(sorted_sequence), as_tensor(values)
    if ss.ndim > 1:
        lead = v.shape[:-1]
        out = torch.searchsorted(ss.reshape(-1, ss.shape[-1]),
                                 v.reshape(-1, v.shape[-1]), right=right,
                                 out_int32=out_int32)
        return out.reshape(*lead, v.shape[-1])
    return torch.searchsorted(ss, v, right=right, out_int32=out_int32)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(as_tensor(x), as_tensor(sorted_sequence),
                           out_int32=out_int32, right=builtins.bool(right))

