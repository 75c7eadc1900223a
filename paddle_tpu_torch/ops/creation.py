"""Tensor creation and random ops (the port of
``paddle_tpu/ops/creation.py``).

New tensors land on the current device (``framework.core``): CUDA by
default, which raises where there is none unless ``set_device("cpu")``
was called. Random ops draw from the generator of the device they fill
(``framework.random``), never from torch's global RNG; their streams
reproduce within the port and are not the reference's (ROADMAP C2)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import dtype as dtypes
from ..framework import random as prandom
from ..framework.core import current_device, to_tensor
from ._util import as_tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
    "ones_like", "full_like", "empty_like", "arange", "linspace", "logspace",
    "eye", "tril", "triu", "diag", "diagflat", "diag_embed", "diagonal",
    "meshgrid", "assign", "clone", "rand", "uniform", "randn",
    "standard_normal", "normal", "randint", "randint_like", "randperm",
    "bernoulli", "multinomial", "poisson", "exponential_", "binomial",
    "standard_gamma", "log_normal", "polar", "vander", "complex",
    "tril_indices", "triu_indices"]


def _dt(dtype, default=None):
    if dtype is None:
        return dtypes.convert_dtype(default) if default else None
    return dtypes.convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [int(shape)]
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype, dtypes.get_default_dtype()),
                       device=current_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype, dtypes.get_default_dtype()),
                      device=current_device())


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _item(fill_value)
    if dtype is None:
        dtype = (dtypes.get_default_dtype() if isinstance(fill_value, float)
                 else None)
    dt = _dt(dtype)
    if dt is None:
        dt = (torch.bool if isinstance(fill_value, builtins.bool)
              else torch.int64 if isinstance(fill_value, int) else None)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=current_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def zeros_like(x, dtype=None, name=None):
    x = _like(x)
    return torch.zeros_like(x, dtype=_dt(dtype) or x.dtype)


def ones_like(x, dtype=None, name=None):
    x = _like(x)
    return torch.ones_like(x, dtype=_dt(dtype) or x.dtype)


def full_like(x, fill_value, dtype=None, name=None):
    x = _like(x)
    return torch.full_like(x, _item(fill_value), dtype=_dt(dtype) or x.dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (dtypes.get_default_dtype()
                 if builtins.any(isinstance(v, float)
                                 for v in (start, end, step)) else "int64")
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=current_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_item(start), _item(stop), int(_item(num)),
                          dtype=_dt(dtype, dtypes.get_default_dtype()),
                          device=current_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_item(start), _item(stop), int(_item(num)),
                          base=base,
                          dtype=_dt(dtype, dtypes.get_default_dtype()),
                          device=current_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(int(num_rows), int(cols),
                     dtype=_dt(dtype, dtypes.get_default_dtype()),
                     device=current_device())


def tril(x, diagonal=0):
    return torch.tril(as_tensor(x), diagonal)


def triu(x, diagonal=0):
    return torch.triu(as_tensor(x), diagonal)


def diag(x, offset=0, padding_value=0):
    x = as_tensor(x)
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.tensor(padding_value,
                                                  dtype=out.dtype,
                                                  device=out.device))
    return out


def diagflat(x, offset=0):
    return torch.diagflat(as_tensor(x), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(as_tensor(x), offset, dim1, dim2)


def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(as_tensor(x), offset, axis1, axis2)


def meshgrid(*args, **kwargs):
    arrs = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
            else args)
    return list(torch.meshgrid(*[as_tensor(a) for a in arrs], indexing="ij"))


def assign(x, output=None):
    """A copy of ``x``; with ``output``, written into it in place."""
    val = x.clone() if isinstance(x, torch.Tensor) \
        else to_tensor(np.asarray(x))
    if output is None:
        return val
    with torch.no_grad():
        if output.shape == val.shape:
            output.copy_(val)
        else:
            output.set_(val.to(output.dtype))
    return output


def clone(x):
    return x.clone()


# -- random -----------------------------------------------------------------

def _gen(device):
    return prandom.generator(device)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    """U[min, max) from the device's generator, or, with a nonzero
    ``seed``, from a generator of its own seeded with it."""
    dev = current_device()
    gen = _gen(dev)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    u = torch.rand(_shape(shape), generator=gen, device=dev,
                   dtype=_dt(dtype, dtypes.get_default_dtype()))
    return u * (max - min) + min


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return torch.randn(_shape(shape), generator=_gen(dev), device=dev,
                       dtype=_dt(dtype, dtypes.get_default_dtype()))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        sh = torch.broadcast_shapes(torch.as_tensor(mean).shape,
                                    torch.as_tensor(std).shape)
        z = torch.randn(sh, generator=_gen(like.device), device=like.device,
                        dtype=like.dtype if like.dtype.is_floating_point
                        else dtypes.default_float())
        return z * std + mean
    return randn(shape) * std + mean


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_gen(dev), device=dev,
                         dtype=_dt(dtype) or torch.int64)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    """Integers in [low, high) of ``x``'s shape on its device, in ``dtype``
    (None: ``x``'s, a float one included)."""
    if high is None:
        low, high = 0, low
    dt = _dt(dtype) or x.dtype
    return torch.randint(int(low), int(high), tuple(x.shape),
                         generator=_gen(x.device), device=x.device,
                         dtype=torch.int64).to(dt)


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return torch.randperm(int(n), generator=_gen(dev), device=dev,
                          dtype=_dt(dtype))


def bernoulli(x, name=None):
    p = as_tensor(x)
    return torch.bernoulli(p, generator=_gen(p.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = as_tensor(x)
    return torch.multinomial(p, int(num_samples), replacement=replacement,
                             generator=_gen(p.device))


def poisson(x, name=None):
    lam = as_tensor(x)
    return torch.poisson(lam, generator=_gen(lam.device))


def exponential_(x, lam=1.0, name=None):
    """Fill ``x`` in place with Exp(lam) draws."""
    with torch.no_grad():
        x.exponential_(lam, generator=_gen(x.device))
    return x


def binomial(count, prob, name=None):
    """Binomial(count, prob) draws per element, as int64 (the reference's
    int32, ROADMAP C26)."""
    n, p = torch.broadcast_tensors(as_tensor(count), as_tensor(prob))
    out = torch.binomial(n.float(), p.float(), generator=_gen(n.device))
    return out.to(torch.int64)


def standard_gamma(x, name=None):
    a = as_tensor(x)
    return torch._standard_gamma(a, generator=_gen(a.device))


def log_normal(mean=1.0, std=2.0, shape=None, dtype=None, name=None):
    shape = [1] if shape is None else list(shape)
    z = randn(shape, "float32")
    return torch.exp(mean + std * z).to(_dt(dtype, "float32"))


def polar(abs, angle, name=None):
    return torch.polar(as_tensor(abs), as_tensor(angle))


def vander(x, n=None, increasing=False, name=None):
    return torch.vander(as_tensor(x), N=n, increasing=increasing)


def complex(real, imag, name=None):
    return torch.complex(as_tensor(real), as_tensor(imag))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=_dt(dtype, "int64"),
                              device=current_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              dtype=_dt(dtype, "int64"),
                              device=current_device())
