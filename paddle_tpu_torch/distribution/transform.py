"""Bijective transforms and ``TransformedDistribution`` (port of
``paddle_tpu/distribution/transform.py``): forward, inverse and
``log |det J|`` of each, and their event ranks (``_event_rank``: the
rank of the output's event one application consumes)."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from .distribution import Distribution, _param, _shape_tuple


class Transform:
    """Bijection ``y = f(x)`` with ``log |det J|``."""

    _event_rank = 0

    def forward(self, x):
        return self._forward(_param(x))

    def inverse(self, y):
        return self._inverse(_param(y))

    def forward_log_det_jacobian(self, x):
        return self._log_det(_param(x))

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def _forward(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError

    def _log_det(self, x):
        raise NotImplementedError


class AffineTransform(Transform):
    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def _forward(self, x):
        return _param(self.loc) + _param(self.scale) * x

    def _inverse(self, y):
        return (y - _param(self.loc)) / _param(self.scale)

    def _log_det(self, x):
        return torch.log(torch.abs(_param(self.scale))).broadcast_to(x.shape)


class ExpTransform(Transform):
    def _forward(self, x):
        return torch.exp(x)

    def _inverse(self, y):
        return torch.log(y)

    def _log_det(self, x):
        return x


class PowerTransform(Transform):
    def __init__(self, power):
        self.power = power

    def _forward(self, x):
        return torch.pow(x, _param(self.power))

    def _inverse(self, y):
        return torch.pow(y, 1.0 / _param(self.power))

    def _log_det(self, x):
        p = _param(self.power)
        return torch.log(torch.abs(p * torch.pow(x, p - 1)))


class AbsTransform(Transform):
    """``|x|``: not bijective; the inverse takes the principal branch."""

    def _forward(self, x):
        return torch.abs(x)

    def _inverse(self, y):
        return y

    def _log_det(self, x):
        return torch.zeros_like(x)


class SigmoidTransform(Transform):
    def _forward(self, x):
        return torch.sigmoid(x)

    def _inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def _log_det(self, x):
        return -F.softplus(-x) - F.softplus(x)


class TanhTransform(Transform):
    def _forward(self, x):
        return torch.tanh(x)

    def _inverse(self, y):
        return torch.atanh(y)

    def _log_det(self, x):
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class SoftmaxTransform(Transform):
    """exp and normalise over the last axis (not bijective; the
    reference's forward / inverse pair)."""

    _event_rank = 1

    def _forward(self, x):
        return torch.softmax(x, dim=-1)

    def _inverse(self, y):
        return torch.log(y)

    def _log_det(self, x):
        raise NotImplementedError("SoftmaxTransform has no log-det")


class StickBreakingTransform(Transform):
    """``R^(K-1)`` -> the K-simplex."""

    _event_rank = 1

    def _forward(self, x):
        offset = x.shape[-1] - torch.cumsum(torch.ones_like(x), -1) + 1
        z = torch.sigmoid(x - torch.log(offset))
        zpad = torch.cat([z, torch.ones_like(z[..., :1])], -1)
        one_minus = torch.cat(
            [torch.ones_like(z[..., :1]), torch.cumprod(1 - z, -1)], -1)
        return zpad * one_minus

    def _inverse(self, y):
        ycum = torch.cumsum(y[..., :-1], -1)
        rest = 1 - torch.cat([torch.zeros_like(y[..., :1]), ycum[..., :-1]],
                             -1)
        offset = y.shape[-1] - 1 - torch.cumsum(
            torch.ones_like(y[..., :-1]), -1) + 1
        z = y[..., :-1] / rest
        return torch.log(z / (1 - z)) + torch.log(offset)

    def _log_det(self, x):
        offset = x.shape[-1] - torch.cumsum(torch.ones_like(x), -1) + 1
        z = torch.sigmoid(x - torch.log(offset))
        rest = torch.cat([torch.ones_like(z[..., :1]),
                          torch.cumprod(1 - z, -1)[..., :-1]], -1)
        return (torch.log(z) + torch.log1p(-z) + torch.log(rest)).sum(-1)


class ReshapeTransform(Transform):
    def __init__(self, in_event_shape, out_event_shape):
        self.in_event_shape = _shape_tuple(in_event_shape)
        self.out_event_shape = _shape_tuple(out_event_shape)
        if int(np.prod(self.in_event_shape or (1,))) != int(
                np.prod(self.out_event_shape or (1,))):
            raise ValueError("reshape must preserve the event size")
        self._event_rank = len(self.out_event_shape)

    def _forward(self, x):
        lead = tuple(x.shape[:x.ndim - len(self.in_event_shape)])
        return x.reshape(lead + self.out_event_shape)

    def _inverse(self, y):
        lead = tuple(y.shape[:y.ndim - len(self.out_event_shape)])
        return y.reshape(lead + self.in_event_shape)

    def _log_det(self, x):
        lead = tuple(x.shape[:x.ndim - len(self.in_event_shape)])
        return torch.zeros(lead, dtype=x.dtype, device=x.device)


class IndependentTransform(Transform):
    """``base`` with ``reinterpreted_batch_ndims`` batch dimensions made
    event dimensions (its log-det summed over them)."""

    def __init__(self, base, reinterpreted_batch_ndims):
        self.base = base
        self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)
        self._event_rank = base._event_rank + self.reinterpreted_batch_ndims

    def _forward(self, x):
        return self.base._forward(x)

    def _inverse(self, y):
        return self.base._inverse(y)

    def _log_det(self, x):
        ld = self.base._log_det(x)
        n = self.reinterpreted_batch_ndims
        return ld.sum(dim=tuple(range(ld.ndim - n, ld.ndim))) if n else ld


class StackTransform(Transform):
    """A list of transforms applied to the slices of ``axis``."""

    def __init__(self, transforms, axis=0):
        self.transforms = list(transforms)
        self.axis = int(axis)

    def _map(self, fn_name, x):
        parts = torch.chunk(x, len(self.transforms), dim=self.axis)
        outs = [getattr(t, fn_name)(p.squeeze(self.axis))
                for t, p in zip(self.transforms, parts)]
        return torch.stack(outs, dim=self.axis)

    def _forward(self, x):
        return self._map("_forward", x)

    def _inverse(self, y):
        return self._map("_inverse", y)

    def _log_det(self, x):
        return self._map("_log_det", x)


class ChainTransform(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)
        self._event_rank = max((t._event_rank for t in self.transforms),
                               default=0)

    def _forward(self, x):
        for t in self.transforms:
            x = t._forward(x)
        return x

    def _inverse(self, y):
        for t in reversed(self.transforms):
            y = t._inverse(y)
        return y

    def _log_det(self, x):
        total = None
        for t in self.transforms:
            ld = t._log_det(x)
            total = ld if total is None else total + ld
            x = t._forward(x)
        return total


def _sum_rightmost(a, n):
    return a.sum(dim=tuple(range(a.ndim - n, a.ndim))) if n > 0 else a


class TransformedDistribution(Distribution):
    """``base`` pushed through ``transforms`` in order."""

    def __init__(self, base, transforms):
        self.base = base
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transforms = list(transforms)
        self._chain = ChainTransform(self.transforms)
        extra = self._chain._event_rank - len(base.event_shape)
        if extra > 0:
            # the transforms consume batch dimensions as event dimensions
            shape = base.batch_shape + base.event_shape
            cut = len(shape) - self._chain._event_rank
            super().__init__(shape[:cut], shape[cut:])
        else:
            super().__init__(base.batch_shape, base.event_shape)

    def sample(self, shape=()):
        x = self.base.sample(shape)
        for t in self.transforms:
            x = t.forward(x)
        return x.detach()

    def rsample(self, shape=()):
        x = self.base.rsample(shape)
        for t in self.transforms:
            x = t.forward(x)
        return x

    def log_prob(self, value):
        """The base's log_prob at the pulled-back value minus the
        accumulated log-det, each reduced to the distribution's event
        rank."""
        y = _param(value)
        event_rank = max(self._chain._event_rank, len(self.base.event_shape))
        lp = None
        for t in reversed(self.transforms):
            x = t.inverse(y)
            ld = _sum_rightmost(t._log_det(x), event_rank - t._event_rank)
            lp = ld if lp is None else lp + ld
            y = x
        base_lp = _sum_rightmost(self.base.log_prob(y),
                                 event_rank - len(self.base.event_shape))
        return base_lp if lp is None else base_lp - lp
