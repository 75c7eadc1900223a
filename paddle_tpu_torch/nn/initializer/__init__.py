"""Initializers (port of ``paddle_tpu/nn/initializer/__init__.py``):
callables ``init(shape, dtype="float32", device=None) -> torch.Tensor``.

Random ones draw from the port's generator of the device
(``framework/random.py``, reseeded by ``paddle.seed``), never from
torch's global RNG. The draws are not the reference's JAX key streams
(ROADMAP C2); the fans, gains, bounds and standard deviations are the
reference's, and the deterministic initializers (``Constant``,
``Assign``, ``Dirac``, ``Bilinear``) give its values bit for bit.

``device=None`` is the device a ``torch.device`` context sets (``meta``
inside one: then nothing is drawn), else the port's current device
(``paddle.get_device()``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import core
from ...framework import dtype as dtypes
from ...framework import random as prandom


def param_device(device=None):
    """The device a new parameter lands on (see the module's doc)."""
    if device is not None:
        return torch.device(device)
    default = torch.get_default_device()
    if default.type != "cpu":
        return default
    return core.current_device()


def _fans(shape):
    """(fan_in, fan_out) of a weight in Paddle's layout: ``[in, out]`` for
    a matrix, ``[out_c, in_c, *kernel]`` for a convolution."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, dtype, device):
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=dtypes.convert_dtype(dtype),
                       device=param_device(device))


def _drawn(t):
    """The generator to draw ``t`` from, or None on the meta device."""
    return None if t.device.type == "meta" else prandom.generator(t.device)


class Initializer:
    def __call__(self, shape, dtype="float32", device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        return _empty(shape, dtype, device).fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        gen = _drawn(t)
        if gen is not None:
            t.normal_(self.mean, self.std, generator=gen)
        return t


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` standard normal cut to ``[a, b]`` (in
    standard units, as the reference's ``truncated_normal``), drawn by
    the inverse CDF."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        gen = _drawn(t)
        if gen is None:
            return t
        lo = 0.5 * (1.0 + math.erf(self.a / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(self.b / math.sqrt(2.0)))
        u = torch.empty(t.shape, device=t.device).uniform_(lo, hi,
                                                           generator=gen)
        z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(self.a,
                                                                  self.b)
        return t.copy_(z * self.std + self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        gen = _drawn(t)
        if gen is not None:
            t.uniform_(self.low, self.high, generator=gen)
        return t


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape):
        fin, fout = _fans(shape)
        fin, fout = self.fan_in or fin, self.fan_out or fout
        return self.gain * math.sqrt(2.0 / (fin + fout))

    def __call__(self, shape, dtype="float32", device=None):
        return Normal(0.0, self.std(shape))(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        fin, fout = _fans(shape)
        fin, fout = self.fan_in or fin, self.fan_out or fout
        return self.gain * math.sqrt(6.0 / (fin + fout))

    def __call__(self, shape, dtype="float32", device=None):
        lim = self.limit(shape)
        return Uniform(-lim, lim)(shape, dtype, device)


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain_fan(self, shape):
        fin = self.fan_in or _fans(shape)[0]
        gain = (math.sqrt(2.0 / (1 + self.negative_slope ** 2))
                if self.nonlinearity in ("relu", "leaky_relu") else 1.0)
        return gain, fin


class KaimingNormal(_Kaiming):
    def std(self, shape):
        gain, fin = self._gain_fan(shape)
        return gain / math.sqrt(fin)

    def __call__(self, shape, dtype="float32", device=None):
        return Normal(0.0, self.std(shape))(shape, dtype, device)


class KaimingUniform(_Kaiming):
    def limit(self, shape):
        gain, fin = self._gain_fan(shape)
        return gain * math.sqrt(3.0 / fin)

    def __call__(self, shape, dtype="float32", device=None):
        lim = self.limit(shape)
        return Uniform(-lim, lim)(shape, dtype, device)


class Assign(Initializer):
    """The given value (a tensor, an array or nested lists), reshaped to
    ``shape`` when its own shape differs."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        v = self.value
        v = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        if tuple(v.shape) != tuple(shape):
            v = v.reshape(tuple(shape))
        t = _empty(shape, dtype, device)
        if t.device.type == "meta":
            return t
        return t.copy_(torch.from_numpy(np.array(v)))


class Orthogonal(Initializer):
    """A standard normal ``[max(r, c), min(r, c)]`` matrix's QR factor,
    signs fixed by ``R``'s diagonal, transposed when ``r < c``, times
    ``gain`` (``r = shape[0]``, ``c`` the product of the rest)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None):
        t = _empty(shape, dtype, device)
        gen = _drawn(t)
        if gen is None:
            return t
        rows, cols = shape[0], int(np.prod(shape[1:]))
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           device=t.device).normal_(generator=gen)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return t.copy_((self.gain * q[:rows, :cols]).reshape(t.shape))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32", device=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i) + centers] = 1.0
        return Assign(out)(shape, dtype, device)


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a transposed convolution: each
    ``[kh, kw]`` slice of the 4-D weight is the separable triangle filter
    ``(1 - |x / f - c|)`` with ``f = ceil(k / 2)``, ``c = (2f - 1 - f % 2)
    / (2f)``."""

    def __call__(self, shape, dtype="float32", device=None):
        shape = tuple(shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        og = np.ogrid[:kh, :kw]
        filt = (1 - np.abs(og[0] / fh - ch)) * (1 - np.abs(og[1] / fw - cw))
        w = np.zeros(shape, np.float32)
        w[:, :] = filt
        return Assign(w)(shape, dtype, device)


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
             "selu": 3.0 / 4}
    if nonlinearity == "leaky_relu":
        slope = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + slope ** 2))
    return gains.get(nonlinearity, 1.0)


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """Record the global initializers, as the reference does (it reads
    them nowhere either)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init


__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac", "Bilinear",
           "calculate_gain", "set_global_initializer"]
