"""The top-level in-place ops the reference defines as aliases of Tensor
methods (``paddle.scatter_``, ``tril_``, ``triu_``, ``normal_``,
``bernoulli_``): ``op_(x, *args, **kwargs)`` takes the Tensor method's
arguments, changes ``x`` and returns it."""
from __future__ import annotations

import torch

from ..framework import random as prandom
from . import manipulation

__all__ = ["scatter_", "tril_", "triu_", "normal_", "bernoulli_"]


def scatter_(x, *a, **kw):
    """(index, updates, overwrite=True): ``scatter`` into ``x``."""
    return x.copy_(manipulation.scatter(x, *a, **kw))


def tril_(x, *a, **kw):
    """(diagonal=0)"""
    return x.tril_(*a, **kw)


def triu_(x, *a, **kw):
    """(diagonal=0)"""
    return x.triu_(*a, **kw)


def normal_(x, *a, **kw):
    """(mean=0.0, std=1.0): N(mean, std) draws from ``x``'s device's
    generator."""
    with torch.no_grad():
        return x.normal_(*a, **kw, generator=prandom.generator(x.device))


def bernoulli_(x, *a, **kw):
    """(p=0.5): Bernoulli(p) draws from ``x``'s device's generator."""
    with torch.no_grad():
        return x.bernoulli_(*a, **kw, generator=prandom.generator(x.device))
