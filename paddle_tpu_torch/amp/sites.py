"""Op sites for the reference's Tensor methods and operators.

The reference casts every op's tensors at ``tape.apply`` under the op's
name; its Tensor methods (``reshape``, ``transpose``, ``unsqueeze``,
``__getitem__``) and operators (``+``, ``*``) are ops there like any
other. A module of the port that stands where the reference calls one of
them calls the function of the same name here: the tensors are cast by
the AMP policy (:func:`~paddle_tpu_torch.amp.amp_cast_inputs`) under the
reference's op name, and mixed float dtypes promote as jnp promotes
them (:func:`~paddle_tpu_torch.amp.promote`)."""
from __future__ import annotations

import torch

from . import amp_cast_inputs, promote


def add(a, b):
    """``a + b``, the op ``"add"``."""
    return torch.add(*promote(*amp_cast_inputs("add", [a, b])))


def multiply(a, b):
    """``a * b``, the op ``"multiply"`` (``b`` may be a Python number,
    which keeps ``a``'s dtype as a weakly typed jnp scalar does)."""
    return torch.mul(*promote(*amp_cast_inputs("multiply", [a, b])))


def reshape(x, *shape):
    (x,) = amp_cast_inputs("reshape", [x])
    return x.reshape(*shape)


def getitem(x, index):
    (x,) = amp_cast_inputs("getitem", [x])
    return x[index]


def transpose(x, perm):
    """Paddle's ``transpose``: ``perm`` is a permutation of every axis."""
    (x,) = amp_cast_inputs("transpose", [x])
    return x.permute(*perm)


def unsqueeze(x, axis):
    (x,) = amp_cast_inputs("unsqueeze", [x])
    return x.unsqueeze(axis)


def concat(xs, axis):
    """``concat`` of ``xs`` along ``axis``, promoted to one dtype."""
    return torch.cat(promote(*amp_cast_inputs("concat", list(xs))),
                     dim=axis)


def matmul_t(x, w):
    """``matmul(x, w, transpose_y=True)``, the op ``"matmul"``: a tied
    head's logits over an embedding ``w [vocab, hidden]``."""
    x, w = promote(*amp_cast_inputs("matmul", [x, w]))
    return torch.nn.functional.linear(x, w)
