"""Elementwise math, reductions, matrix products and checks (the port of
``paddle_tpu/ops/math.py``).

Ops take and return ``torch.Tensor``; mixed dtypes promote as jnp
promotes (``_util.binary``) and gradients come from torch's autograd,
which agrees with the reference's tape on these ops. Index and count
outputs are int64 where the reference narrows to int32 (ROADMAP C26)."""
from __future__ import annotations

import builtins
import functools
import itertools
import operator

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework import random as prandom
from ._util import as_tensor, axis_arg, binary, dims, floating, promote

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "floor_mod", "pow", "maximum", "minimum", "fmax", "fmin",
    "atan2", "hypot", "heaviside", "lerp", "logaddexp", "nextafter",
    "copysign", "gcd", "lcm", "divide_no_nan", "exp", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "square", "abs", "sign", "neg",
    "negative", "reciprocal", "floor", "ceil", "round", "trunc", "frac",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid", "logit",
    "digamma", "lgamma", "i0", "deg2rad", "rad2deg", "angle", "conj", "real",
    "imag", "clip", "scale", "stanh", "multiplex", "nan_to_num",
    "trapezoid", "cumulative_trapezoid", "sgn", "cdist", "sum", "mean",
    "prod", "max", "min", "amax", "amin", "logsumexp", "std", "var",
    "median", "nanmedian", "quantile", "nansum", "nanmean", "count_nonzero",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "matmul", "mm",
    "bmm", "dot", "inner", "outer", "addmm", "kron", "cross", "trace", "t",
    "einsum", "isnan", "isinf", "isfinite", "isclose", "allclose",
    "equal_all", "histogram", "bincount", "increment", "all", "any", "diff",
    "mv", "take", "broadcast_shape", "add_n", "clip_by_norm", "ldexp",
    "frexp", "sinc", "signbit", "isneginf", "isposinf", "isreal", "i0e",
    "i1", "i1e", "polygamma", "gammainc", "gammaincc", "igamma", "igammac",
    "multigammaln", "nanquantile", "renorm", "bitwise_left_shift",
    "bitwise_right_shift", "cartesian_prod", "combinations", "float_power",
    "vdot", "nanargmax", "nanargmin", "positive", "isin", "histogramdd",
    "gammaln", "histogram_bin_edges", "reduce_as", "pdist",
    "top_p_sampling"]


def _dt(dtype):
    return dtypes.convert_dtype(dtype) if dtype else None


# ---------------------------------------------------------------------------
# binary elementwise
# ---------------------------------------------------------------------------

def add(x, y):
    return binary(torch.add, x, y)


def subtract(x, y):
    return binary(torch.sub, x, y)


def multiply(x, y):
    return binary(torch.mul, x, y)


def divide(x, y):
    return binary(torch.true_divide, x, y)


def floor_divide(x, y):
    return binary(torch.floor_divide, x, y)


def mod(x, y):
    """Python's sign rule (the divisor's), as ``jnp.mod``."""
    return binary(torch.remainder, x, y)


remainder = mod
floor_mod = mod


def pow(x, y):
    return binary(torch.pow, x, y)


def maximum(x, y):
    return binary(torch.maximum, x, y)


def minimum(x, y):
    return binary(torch.minimum, x, y)


def fmax(x, y):
    return binary(torch.fmax, x, y)


def fmin(x, y):
    return binary(torch.fmin, x, y)


def atan2(x, y):
    return binary(torch.atan2, x, y)


def hypot(x, y):
    return binary(torch.hypot, x, y)


def heaviside(x, y):
    return binary(torch.heaviside, x, y)


def lerp(x, y, weight):
    return x + weight * (y - x)


def logaddexp(x, y):
    return binary(torch.logaddexp, x, y)


def nextafter(x, y):
    return binary(torch.nextafter, x, y)


def copysign(x, y):
    return binary(torch.copysign, x, y)


def gcd(x, y):
    return binary(torch.gcd, x, y)


def lcm(x, y):
    return binary(torch.lcm, x, y)


def divide_no_nan(x, y):
    def fn(a, b):
        zero = b == 0
        return torch.where(zero, torch.zeros((), dtype=a.dtype,
                                             device=a.device),
                           a / torch.where(zero, torch.ones_like(b), b))
    return binary(fn, x, y)


# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------

def _unary(name, fn):
    def op(x):
        return fn(as_tensor(x))
    op.__name__ = op.__qualname__ = name
    return op


def _real_part(x):
    return torch.real(x) if x.is_complex() else x


def _imag_part(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
log = _unary("log", torch.log)
log2 = _unary("log2", torch.log2)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
sqrt = _unary("sqrt", torch.sqrt)
rsqrt = _unary("rsqrt", torch.rsqrt)
square = _unary("square", torch.square)
abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
neg = _unary("neg", torch.neg)
negative = neg
reciprocal = _unary("reciprocal", torch.reciprocal)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)          # half to even, as jnp.round
trunc = _unary("trunc", torch.trunc)
frac = _unary("frac", lambda x: x - torch.trunc(x))
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)
tan = _unary("tan", torch.tan)
asin = _unary("asin", torch.asin)
acos = _unary("acos", torch.acos)
atan = _unary("atan", torch.atan)
sinh = _unary("sinh", torch.sinh)
cosh = _unary("cosh", torch.cosh)
tanh = _unary("tanh", torch.tanh)
asinh = _unary("asinh", torch.asinh)
acosh = _unary("acosh", torch.acosh)
atanh = _unary("atanh", torch.atanh)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
sigmoid = _unary("sigmoid", torch.sigmoid)
logit = _unary("logit", torch.logit)
digamma = _unary("digamma", torch.digamma)
lgamma = _unary("lgamma", torch.lgamma)
i0 = _unary("i0", torch.i0)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
angle = _unary("angle", torch.angle)
conj = _unary("conj", torch.conj_physical)
real = _unary("real", _real_part)
imag = _unary("imag", _imag_part)


def clip(x, min=None, max=None):
    x = as_tensor(x)
    mn = min.item() if isinstance(min, torch.Tensor) else min
    mx = max.item() if isinstance(max, torch.Tensor) else max
    if mn is None and mx is None:
        return x
    return torch.clamp(x, mn, mx)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    x = as_tensor(x)
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * as_tensor(x))


def multiplex(inputs, index):
    stacked = torch.stack(promote(*inputs), dim=0)     # [n, batch, ...]
    idx = as_tensor(index).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(as_tensor(x), nan=nan, posinf=posinf,
                            neginf=neginf)


def trapezoid(y, x=None, dx=None, axis=-1):
    y = as_tensor(y)
    if x is not None:
        return torch.trapezoid(y, as_tensor(x, y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    y = as_tensor(y)
    ax = int(axis) % y.ndim
    n = y.shape[ax]
    lo, hi = y.narrow(ax, 0, n - 1), y.narrow(ax, 1, n - 1)
    if x is not None:
        xa = as_tensor(x, y)
        if xa.ndim == 1:
            shape = [1] * y.ndim
            shape[ax] = n
            xa = xa.reshape(shape)
        d = xa.narrow(ax, 1, n - 1) - xa.narrow(ax, 0, n - 1)
    else:
        d = 1.0 if dx is None else dx
    return torch.cumsum((lo + hi) * 0.5 * d, dim=ax)


def sgn(x):
    return torch.sgn(as_tensor(x))


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    """Distances between the rows of ``x [*, P, M]`` and ``y [*, R, M]``.
    For p = 2 the reference's matrix form, ``|x|^2 + |y|^2 - 2 x.y``
    clamped at 0, with zero distances masked out of the square root so
    their gradient is 0, not NaN."""
    x, y = promote(as_tensor(x), as_tensor(y))
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x2 = (x * x).sum(-1)[..., :, None]
        y2 = (y * y).sum(-1)[..., None, :]
        d2 = torch.clamp(x2 + y2 - 2.0 * (x @ y.transpose(-1, -2)), min=0.0)
        zero = d2 == 0.0
        safe = torch.where(zero, torch.ones_like(d2), d2)
        return torch.where(zero, torch.zeros_like(d2), torch.sqrt(safe))
    diff_ = x[..., :, None, :] - y[..., None, :, :]
    if p == 0:
        return (diff_ != 0).to(x.dtype).sum(-1)
    if np.isinf(p):
        return diff_.abs().amax(-1)
    return (diff_.abs() ** p).sum(-1) ** (1.0 / p)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

#: integer and bool inputs a sum, product or cumulative op accumulates
#: in int64 (the reference's int32, C26); an int32 one stays int32, as
#: in the reference (torch would widen it)
_WIDENED = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int64)


def _count_dtype(x, dt):
    if dt is not None:
        return dt
    if x.dtype in _WIDENED:
        return torch.int64
    return torch.int32 if x.dtype == torch.int32 else None


def sum(x, axis=None, dtype=None, keepdim=False):
    x = as_tensor(x)
    return torch.sum(x, dim=dims(x, axis), keepdim=keepdim,
                     dtype=_count_dtype(x, _dt(dtype)))


def mean(x, axis=None, keepdim=False):
    x = floating(as_tensor(x))
    return torch.mean(x, dim=dims(x, axis), keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None):
    x = as_tensor(x)
    dt = _count_dtype(x, _dt(dtype))
    if dt is not None:
        x = x.to(dt)
    out = x
    for d in sorted((d % builtins.max(x.ndim, 1) for d in dims(x, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _extreme(fn, x, axis, keepdim):
    x = as_tensor(x)
    return fn(x, dim=dims(x, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False):
    """The maximum; the gradient splits evenly among tied maxima, as jnp's
    does (``torch.amax``)."""
    return _extreme(torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False):
    return _extreme(torch.amin, x, axis, keepdim)


def amax(x, axis=None, keepdim=False):
    return _extreme(torch.amax, x, axis, keepdim)


def amin(x, axis=None, keepdim=False):
    return _extreme(torch.amin, x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False):
    x = floating(as_tensor(x))
    return torch.logsumexp(x, dim=dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False):
    x = floating(as_tensor(x))
    return torch.std(x, dim=dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    x = floating(as_tensor(x))
    return torch.var(x, dim=dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``torch.quantile``/``nanquantile`` over one axis, several (moved to
    the end and flattened, as jnp reduces a tuple of axes) or all."""
    x = floating(as_tensor(x))
    ax = axis_arg(axis)
    qt = q if not isinstance(q, (list, tuple)) else torch.tensor(
        q, dtype=x.dtype, device=x.device)
    if isinstance(qt, torch.Tensor):
        qt = qt.to(device=x.device, dtype=x.dtype)
    if ax is None or isinstance(ax, tuple):
        red = tuple(range(x.ndim)) if ax is None else tuple(
            a % x.ndim for a in ax)
        keep = [d for d in range(x.ndim) if d not in red]
        flat = x.permute(*keep, *red).reshape(
            *[x.shape[d] for d in keep], -1)
        out = fn(flat, qt, dim=-1)
        if keepdim:
            lead = out.ndim - len(keep)         # q's own dims
            for d in sorted(red):
                out = out.unsqueeze(lead + d)
        return out
    return fn(x, qt, dim=ax, keepdim=keepdim)


def median(x, axis=None, keepdim=False):
    """The mean of the two middle values for an even count, as
    ``jnp.median`` (``torch.median`` takes the lower one)."""
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False):
    x = as_tensor(x)
    return torch.nansum(x, dim=dims(x, axis), keepdim=keepdim,
                        dtype=_count_dtype(x, _dt(dtype)))


def nanmean(x, axis=None, keepdim=False):
    x = floating(as_tensor(x))
    return torch.nanmean(x, dim=dims(x, axis), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False):
    x = as_tensor(x)
    return (x != 0).sum(dim=dims(x, axis), keepdim=keepdim)


def cumsum(x, axis=None, dtype=None):
    """Along ``axis``; over the flattened tensor for None."""
    x = as_tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=int(axis), dtype=_count_dtype(x, _dt(dtype)))


def cumprod(x, dim=None, dtype=None):
    x = as_tensor(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=int(dim), dtype=_count_dtype(x, _dt(dtype)))


def _cum_extreme(x, axis, is_max):
    """(values, indices) of the running max or min; a tie keeps the
    earliest index, as the reference's scan (``torch.cummax`` keeps the
    latest)."""
    x = as_tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    ax = int(axis) % x.ndim
    vals = (torch.cummax if is_max else torch.cummin)(x, dim=ax).values
    n = x.shape[ax]
    prev = vals.narrow(ax, 0, builtins.max(n - 1, 0))
    new = (x.narrow(ax, 1, n - 1) > prev) if is_max else \
        (x.narrow(ax, 1, n - 1) < prev)
    new = torch.cat([torch.ones_like(x.narrow(ax, 0, 1), dtype=torch.bool),
                     new], dim=ax)
    shape = [1] * x.ndim
    shape[ax] = n
    pos = torch.arange(n, device=x.device).reshape(shape).expand(x.shape)
    idx = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                       dim=ax).values
    return vals, idx


def cummax(x, axis=None):
    return _cum_extreme(x, axis, True)


def cummin(x, axis=None):
    return _cum_extreme(x, axis, False)


def logcumsumexp(x, axis=None):
    x = floating(as_tensor(x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=int(axis))


# ---------------------------------------------------------------------------
# matrix
# ---------------------------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = promote(as_tensor(x), as_tensor(y))
    if transpose_x and x.ndim >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


mm = matmul


def bmm(x, y):
    return torch.matmul(*promote(as_tensor(x), as_tensor(y)))


def dot(x, y):
    return (as_tensor(x) * as_tensor(y)).sum(-1)


def inner(x, y):
    return torch.inner(*promote(as_tensor(x), as_tensor(y)))


def outer(x, y):
    x, y = promote(as_tensor(x), as_tensor(y))
    return torch.outer(x.reshape(-1), y.reshape(-1))


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * as_tensor(input) + alpha * torch.matmul(
        *promote(as_tensor(x), as_tensor(y)))


def kron(x, y):
    return torch.kron(*promote(as_tensor(x), as_tensor(y)))


def cross(x, y, axis=9):
    """Along ``axis``; the default 9 means the last axis of size 3, else
    the first of size 3."""
    x, y = promote(as_tensor(x), as_tensor(y))
    ax = axis if axis != 9 else (
        x.ndim - 1 if x.shape[-1] == 3 else
        next(i for i, s in enumerate(x.shape) if s == 3))
    return torch.linalg.cross(x, y, dim=ax)


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(as_tensor(x), offset, axis1, axis2).sum(-1)


def t(x):
    x = as_tensor(x)
    return x.T if x.ndim <= 2 else x.transpose(-1, -2)


def einsum(equation, *operands):
    return torch.einsum(equation, *promote(*operands))


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def isnan(x):
    return torch.isnan(as_tensor(x))


def isinf(x):
    return torch.isinf(as_tensor(x))


def isfinite(x):
    return torch.isfinite(as_tensor(x))


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return binary(functools.partial(torch.isclose, rtol=rtol, atol=atol,
                                    equal_nan=equal_nan), x, y)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y):
    x, y = as_tensor(x), as_tensor(y)
    same = x.shape == y.shape and builtins.bool((x == y).all())
    return torch.tensor(same, device=x.device)


def histogram_bin_edges(x, bins=100, min=0, max=0, name=None):
    """``bins + 1`` evenly spaced edges over [min, max], or over the data's
    range when both are 0; a range of zero width widens by 0.5 each side,
    as ``jnp.histogram_bin_edges``."""
    x = as_tensor(x)
    dt = x.dtype if x.dtype.is_floating_point else dtypes.default_float()
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(x.min()), float(x.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, dtype=dt, device=x.device)


def histogram(x, bins=100, min=0, max=0):
    """Counts in ``bins`` equal bins, the last one closed, as
    ``jnp.histogram``; values outside the range are not counted."""
    a = as_tensor(x).reshape(-1)
    edges = histogram_bin_edges(a, bins, min, max)
    af = a.to(edges.dtype)
    idx = torch.searchsorted(edges, af, right=True)
    idx = torch.where(af == edges[-1], len(edges) - 1, idx)
    valid = (idx >= 1) & (idx <= int(bins))
    return torch.bincount(idx[valid] - 1, minlength=int(bins))


def bincount(x, weights=None, minlength=0):
    x = as_tensor(x)
    w = None if weights is None else as_tensor(weights, x)
    return torch.bincount(x, weights=w, minlength=int(minlength))


def increment(x, value=1.0):
    return as_tensor(x) + value


def _bool_reduce(fn, x, axis, keepdim):
    x = as_tensor(x).bool()
    out = x
    for d in sorted((d % builtins.max(x.ndim, 1) for d in dims(x, axis)),
                    reverse=True):
        out = fn(out, dim=d, keepdim=keepdim)
    return out


def all(x, axis=None, keepdim=False, name=None):
    return _bool_reduce(torch.all, x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return _bool_reduce(torch.any, x, axis, keepdim)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = as_tensor(x)
    return torch.diff(x, n=n, dim=axis,
                      prepend=None if prepend is None else as_tensor(prepend,
                                                                     x),
                      append=None if append is None else as_tensor(append, x))


def mv(x, vec, name=None):
    return as_tensor(x) @ as_tensor(vec)


def take(x, index, mode="raise", name=None):
    """Elements of the flattened ``x``: ``"raise"`` checks the bounds and
    reads negative indices from the end, ``"wrap"`` wraps, ``"clip"``
    clamps into [0, n)."""
    x, index = as_tensor(x), as_tensor(index)
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "raise":
        if idx.numel() and builtins.bool(((idx < -n) | (idx >= n)).any()):
            raise IndexError(f"paddle.take: index out of range for input "
                             f"with {n} elements (mode='raise')")
        idx = torch.where(idx < 0, idx + n, idx)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(0, n - 1)
    return flat[idx]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


# ---------------------------------------------------------------------------
# the reference's later additions
# ---------------------------------------------------------------------------

def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    return functools.reduce(operator.add, promote(*inputs))


def clip_by_norm(x, max_norm):
    x = as_tensor(x)
    xf = x.float()
    n = torch.sqrt((xf * xf).sum())
    s = torch.where(n > max_norm, max_norm / torch.clamp(n, min=1e-12),
                    torch.ones_like(n))
    return (xf * s).to(x.dtype)


def ldexp(x, y):
    x, y = as_tensor(x), as_tensor(y)
    return torch.ldexp(x.float(), y.to(torch.int32)).float()


def frexp(x):
    m, e = torch.frexp(as_tensor(x))
    return m, e.to(torch.int32)


sinc = _unary("sinc", torch.sinc)
signbit = _unary("signbit", torch.signbit)
isneginf = _unary("isneginf", torch.isneginf)
isposinf = _unary("isposinf", torch.isposinf)
isreal = _unary("isreal", torch.isreal)
i0e = _unary("i0e", torch.special.i0e)
i1 = _unary("i1", torch.special.i1)
i1e = _unary("i1e", torch.special.i1e)


def polygamma(x, n=1):
    return torch.polygamma(int(n), as_tensor(x))


def gammainc(x, y):
    """The regularized lower incomplete gamma function P(x, y)."""
    return binary(torch.special.gammainc, x, y)


def gammaincc(x, y):
    return binary(torch.special.gammaincc, x, y)


igamma = gammainc
igammac = gammaincc


def multigammaln(x, p):
    return torch.mvlgamma(as_tensor(x), int(p))


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` whose p-norm (in fp32) exceeds
    ``max_norm`` scaled down to it (the reference's formula)."""
    x = as_tensor(x)
    ax = axis % x.ndim
    red = tuple(d for d in range(x.ndim) if d != ax)
    norms = (x.float().abs() ** p).sum(dim=red, keepdim=True) ** (1.0 / p)
    s = torch.where(norms > max_norm,
                    max_norm / torch.clamp(norms, min=1e-12),
                    torch.ones_like(norms))
    return (x * s).to(x.dtype)


def bitwise_left_shift(x, y):
    return binary(torch.bitwise_left_shift, x, y)


def bitwise_right_shift(x, y):
    return binary(torch.bitwise_right_shift, x, y)


def cartesian_prod(x):
    """The Cartesian product of 1-D tensors, one row a combination; one
    tensor comes back as it is."""
    xs = [as_tensor(a) for a in x]
    if len(xs) == 1:
        return xs[0]
    grids = torch.meshgrid(*promote(*xs), indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def combinations(x, r=2, with_replacement=False):
    x = as_tensor(x)
    n = x.shape[0]
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    idx = torch.tensor(list(it), dtype=torch.int64,
                       device=x.device).reshape(-1, r)
    return x[idx]


def float_power(x, y):
    """In float64, as Paddle (the reference computes in float32, C26)."""
    return binary(torch.float_power, x, y)


def vdot(x, y):
    x, y = promote(as_tensor(x), as_tensor(y))
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def _nan_arg(x, axis, keepdim, fill, fn):
    x = as_tensor(x)
    filled = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
    if axis is None:
        return fn(filled.reshape(-1), 0)
    return fn(filled, int(axis), keepdim=keepdim)


def nanargmax(x, axis=None, keepdim=False):
    return _nan_arg(x, axis, keepdim, float("-inf"), torch.argmax)


def nanargmin(x, axis=None, keepdim=False):
    return _nan_arg(x, axis, keepdim, float("inf"), torch.argmin)


def positive(x):
    return torch.positive(as_tensor(x))


def isin(x, test_x, assume_unique=False, invert=False):
    x = as_tensor(x)
    return torch.isin(x, as_tensor(test_x, x), assume_unique=assume_unique,
                      invert=invert)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """(hist, edges) of the rows of ``x [N, D]``: ``torch.histogramdd``."""
    x = as_tensor(x)
    rng = None if ranges is None else [float(v) for v in np.ravel(ranges)]
    w = None if weights is None else as_tensor(weights, x)
    return torch.histogramdd(x, bins=bins, range=rng, weight=w,
                             density=density)


def gammaln(x):
    return torch.lgamma(as_tensor(x))


def reduce_as(x, target, name=None):
    """``x`` summed down to ``target``'s (broadcast-compatible) shape."""
    x = as_tensor(x)
    tgt = tuple(target.shape) if hasattr(target, "shape") else tuple(target)
    extra = x.ndim - len(tgt)
    out = x.sum(dim=tuple(range(extra))) if extra else x
    keep = tuple(i for i, (s, t_) in enumerate(zip(out.shape, tgt))
                 if s != t_ and t_ == 1)
    return out.sum(dim=keep, keepdim=True) if keep else out


def pdist(x, p=2.0, name=None):
    """The condensed pairwise distances of the rows of a 2-D tensor: the
    upper triangle of ``cdist(x, x)``, by the reference's formulas."""
    a = as_tensor(x)
    n = a.shape[0]
    diff_ = a[:, None, :] - a[None, :, :]
    if p == 2.0:
        d = torch.sqrt(torch.clamp((diff_ * diff_).sum(-1), min=0.0))
    elif p == 0:
        d = (diff_ != 0).sum(-1).to(a.dtype)
    elif p == float("inf"):
        d = diff_.abs().amax(-1)
    else:
        d = (diff_.abs() ** p).sum(-1) ** (1.0 / p)
    iu = torch.triu_indices(n, n, 1, device=a.device)
    return d[iu[0], iu[1]]


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling over the last axis of probabilities ``x`` with a
    cumulative threshold ``ps`` a row: (the drawn token's probability, its
    index [..., 1]). Draws from the device's generator, or with ``seed``
    from a generator of its own."""
    probs, p_row = as_tensor(x), as_tensor(ps, as_tensor(x))
    if threshold is not None:
        probs = torch.where(probs >= threshold, probs,
                            torch.zeros_like(probs))
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sorted_p, dim=-1)
    kth = (csum - sorted_p < p_row[..., None]).sum(-1) - 1
    cutoff = torch.take_along_dim(sorted_p, kth[..., None], dim=-1)
    masked = torch.where(probs >= cutoff, probs, torch.zeros_like(probs))
    gen = prandom.generator(probs.device)
    if seed is not None:
        gen = torch.Generator(device=probs.device)
        gen.manual_seed(int(seed))
    flat = masked.reshape(-1, masked.shape[-1]).float()
    idx = torch.multinomial(flat, 1, generator=gen).reshape(
        *masked.shape[:-1], 1)
    return torch.take_along_dim(probs, idx, dim=-1), idx
