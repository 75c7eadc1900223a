"""Distribution base classes (port of
``paddle_tpu/distribution/distribution.py``): ``Distribution``,
``ExponentialFamily`` and ``Independent``.

Parameters are tensors (a number or an array becomes an fp32 tensor on
the current device); every quantity is torch math on them, so autograd
carries ``log_prob``, ``entropy`` and ``rsample`` back to the parameters.
Draws come only from the port's generator of the parameters' device
(``framework.random.generator``, reseeded by ``paddle.seed``), never from
torch's global RNG: they reproduce within the port, not the reference's
JAX key streams (ROADMAP C2)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as prandom
from ..framework.core import to_tensor


def _param(x):
    """A parameter as a tensor: a tensor as it is, anything else fp32 on
    the current device (not requiring grad)."""
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(np.asarray(x, np.float32))


def _shape_tuple(shape):
    if shape is None:
        return ()
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _bshape(*xs):
    return tuple(torch.broadcast_shapes(*[tuple(x.shape) for x in xs]))


class Distribution:
    """Base of all distributions: ``sample`` / ``rsample`` / ``log_prob`` /
    ``prob`` / ``entropy`` / ``kl_divergence`` over ``batch_shape`` +
    ``event_shape``."""

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = _shape_tuple(batch_shape)
        self._event_shape = _shape_tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    def sample(self, shape=()):
        """A draw without gradient: ``rsample`` cut from the graph."""
        return self.rsample(shape).detach()

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return torch.exp(self.log_prob(value))

    # the reference spells it ``probs``
    def probs(self, value):
        return self.prob(value)

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        from .kl import kl_divergence
        return kl_divergence(self, other)

    def _extend_shape(self, sample_shape):
        return (_shape_tuple(sample_shape) + self.batch_shape
                + self.event_shape)

    def _device(self):
        """The device of the distribution's first tensor parameter."""
        for v in vars(self).values():
            if isinstance(v, torch.Tensor):
                return v.device
            if isinstance(v, Distribution):
                return v._device()
        return torch.device("cpu")

    def _gen(self):
        return prandom.generator(self._device())


class ExponentialFamily(Distribution):
    """The exponential-family base (a marker: every family here has its
    closed forms)."""


class Independent(Distribution):
    """Reinterpret the rightmost ``reinterpreted_batch_ndims`` batch
    dimensions of ``base`` as event dimensions."""

    def __init__(self, base, reinterpreted_batch_ndims):
        self.base = base
        self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)
        shape = base.batch_shape + base.event_shape
        split = len(base.batch_shape) - self.reinterpreted_batch_ndims
        if split < 0:
            raise ValueError(
                "reinterpreted_batch_ndims exceeds batch rank "
                f"({self.reinterpreted_batch_ndims} > "
                f"{len(base.batch_shape)})")
        super().__init__(shape[:split], shape[split:])

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return self.base.rsample(shape)

    def _sum_rightmost(self, a):
        n = self.reinterpreted_batch_ndims
        return a.sum(dim=tuple(range(a.ndim - n, a.ndim))) if n else a

    def log_prob(self, value):
        return self._sum_rightmost(self.base.log_prob(value))

    def entropy(self):
        return self._sum_rightmost(self.base.entropy())


_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
