"""Activations (port of ``paddle_tpu/nn/functional/activation.py``).

Each op casts its tensor arguments by the AMP policy under the
reference's op name (the function's own name, ``"prelu"``,
``"gumbel_softmax"``, ...), then computes what the reference's
``jax.nn`` / ``jnp`` expression computes. The random ops (``rrelu`` in
training, ``gumbel_softmax``) draw from the port's generator of the
input's device (ROADMAP C2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp
from ...framework import dtype as dtypes
from ...framework import random as prandom


def _cast(op, x):
    (x,) = amp.amp_cast_inputs(op, [x])
    return x


def relu(x):
    return torch.relu(_cast("relu", x))


def relu_(x):
    """``relu`` in place: ``x`` takes the result, in its own dtype, and is
    returned (autograd records torch's ``relu_``)."""
    amp.amp_cast_inputs("relu", [x])
    return torch.relu_(x)


def relu6(x):
    return torch.clamp(_cast("relu6", x), 0, 6)


def gelu(x, approximate=False):
    return F.gelu(_cast("gelu", x), approximate="tanh" if approximate
                  else "none")


def silu(x):
    return F.silu(_cast("silu", x))


swish = silu


def sigmoid(x):
    return torch.sigmoid(_cast("sigmoid", x))


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * _cast("hardsigmoid", x) + offset, 0.0, 1.0)


def hardswish(x):
    x = _cast("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(_cast("hardtanh", x), min, max)


def tanh(x):
    return torch.tanh(_cast("tanh", x))


def tanhshrink(x):
    x = _cast("tanhshrink", x)
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01):
    x = _cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0):
    x = _cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return F.celu(_cast("celu", x), alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    x = _cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def softplus(x, beta=1.0, threshold=20.0):
    x = _cast("softplus", x)
    soft = torch.log1p(torch.exp(beta * torch.clamp(x, max=threshold / beta)))
    return torch.where(x * beta > threshold, x, soft / beta)


def softshrink(x, threshold=0.5):
    x = _cast("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def hardshrink(x, threshold=0.5):
    x = _cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def softsign(x):
    x = _cast("softsign", x)
    return x / (1 + x.abs())


def mish(x):
    x = _cast("mish", x)
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def softmax(x, axis=-1, dtype=None, name=None):
    x = _cast("softmax", x)
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    x = _cast("log_softmax", x)
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with standard Gumbel noise ``g``;
    ``hard`` gives the one-hot of the argmax in the forward and the soft
    weights' gradient (straight through)."""
    x = _cast("gumbel_softmax", x)
    u = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        generator=prandom.generator(x.device))
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if not hard:
        return y
    idx = y.argmax(dim=axis, keepdim=True)
    y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
    return y + (y_hard - y).detach()


def maxout(x, groups, axis=1):
    """Output channel ``i`` is the max over the consecutive input channels
    ``i * groups + k``."""
    x = _cast("maxout", x)
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


def glu(x, axis=-1):
    x = _cast("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def prelu(x, weight, data_format="NCHW"):
    x, weight = amp.amp_cast_inputs("prelu", [x, weight])
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True):
    """Negative inputs times a slope drawn per element from
    ``U(lower, upper)`` in training, ``(lower + upper) / 2`` otherwise."""
    x = _cast("rrelu", x)
    if training:
        slope = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
            lower, upper, generator=prandom.generator(x.device))
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def log_sigmoid(x):
    return F.logsigmoid(_cast("log_sigmoid", x))


# the reference spells both: log_sigmoid is canonical, logsigmoid the
# compat alias
logsigmoid = log_sigmoid

__all__ = ["relu", "relu_", "relu6", "gelu", "silu", "swish", "sigmoid",
           "hardsigmoid", "hardswish", "hardtanh", "tanh", "tanhshrink",
           "leaky_relu", "elu", "celu", "selu", "softplus", "softshrink",
           "hardshrink", "softsign", "mish", "softmax", "log_softmax",
           "gumbel_softmax", "maxout", "glu", "prelu", "rrelu",
           "log_sigmoid", "logsigmoid"]
