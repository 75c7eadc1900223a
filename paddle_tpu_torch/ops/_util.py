"""Helpers shared by the ops modules (``logic``, ``creation``, ``math``,
``manipulation``, ``linalg``)."""
from __future__ import annotations

import builtins
import functools

import torch

from ..framework import dtype as dtypes
from ..framework.core import to_tensor


def as_tensor(x, like=None):
    """``x`` as a tensor: a tensor as it is, anything else on ``like``'s
    device (None: the current device)."""
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(x, place=like.device if like is not None else None)


def promote(*xs):
    """Tensors of different dtypes cast to their common one, as jnp
    promotes arrays: a 0-dim tensor counts as fully as an n-dim one (torch
    would let the n-dim tensor's dtype win within a category). Python
    scalars stay as they are, weak as in jnp."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    if len({t.dtype for t in ts}) <= 1:
        return xs
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(x.to(dt) if isinstance(x, torch.Tensor) else x for x in xs)


def binary(fn, x, y):
    """``fn(x, y)`` with jnp's promotion. Tensors promote as
    :func:`promote` does; a Python scalar becomes a 0-dim tensor that
    torch's own rule treats as weak, as jnp treats a scalar; anything else
    becomes a tensor beside the other operand."""
    sx, sy = _scalar(x), _scalar(y)
    if sx and sy:
        x = as_tensor(x)
        sx = False
    if not sx and not isinstance(x, torch.Tensor):
        x = as_tensor(x, y if isinstance(y, torch.Tensor) else None)
    if not sy and not isinstance(y, torch.Tensor):
        y = as_tensor(y, x if isinstance(x, torch.Tensor) else None)
    if sx:
        x = torch.tensor(x, device=y.device)
    elif sy:
        y = torch.tensor(y, device=x.device)
    else:
        x, y = promote(x, y)
    return fn(x, y)


def _scalar(v):
    return isinstance(v, (builtins.bool, int, float, complex))


def axis_arg(axis):
    """Paddle's ``axis`` (None, an int, a list, a tuple or a tensor) ->
    None, an int or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(x, axis):
    """``axis_arg(axis)`` as a tuple of dims, every dim for None."""
    a = axis_arg(axis)
    if a is None:
        return tuple(range(x.ndim))
    return a if isinstance(a, tuple) else (a,)


def floating(x):
    """``x`` in the default floating dtype when it is an integer or bool
    tensor (jnp's mean, median and the like compute in a float)."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x
    return x.to(dtypes.default_float())
