"""Normalizations (port of ``paddle_tpu/nn/functional/norm.py``).

Statistics are taken in float32 and the normalized values cast back to
the input's dtype before the affine weight and bias, as the reference
does. ``batch_norm`` updates the running buffers in place, Paddle's way:
``running = momentum * running + (1 - momentum) * batch`` with momentum
0.9 by default, and the unbiased batch variance (``n / (n - 1)``) in the
running variance."""
from __future__ import annotations

import torch

from ... import amp


def _affine(out, wb, shape=None):
    """``out * weight + bias`` for the present ones, reshaped to
    ``shape``; mixed float dtypes promote as jnp's do."""
    for i, t in enumerate(wb):
        if t is None:
            continue
        out, t = amp.promote(out, t if shape is None else t.reshape(shape))
        out = out * t if i == 0 else out + t
    return out


def _present(*ts):
    return [t for t in ts if t is not None]


def _split(args, weight, bias):
    """The cast weight and bias back out of ``args`` (None where absent)."""
    it = iter(args)
    return [next(it) if t is not None else None for t in (weight, bias)]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    x, *rest = amp.amp_cast_inputs("layer_norm", [x] + _present(weight, bias))
    dims = tuple(range(-len(ns), 0))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    return _affine(out, _split(rest, weight, bias))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """The reference's op ``"rms_norm"``: normalized over the last axis in
    float32, cast back to ``x``'s dtype and scaled by ``weight``."""
    args = amp.amp_cast_inputs("rms_norm", [x] + _present(weight))
    x = args[0]
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is None:
        return out
    out, w = amp.promote(out, args[1])
    return out * w


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Normalize over every axis but the channel one. In training (and
    without ``use_global_stats``) the batch's float32 mean and biased
    variance normalize (op ``"bn_stats"``, then ``"batch_norm"``), and
    the running buffers take the reference's momentum update in place;
    otherwise the running statistics normalize."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    dims = tuple(i for i in range(x.ndim) if i != ch)
    if training and not use_global_stats:
        (xs,) = amp.amp_cast_inputs("bn_stats", [x])
        xf = xs.float()
        mean = xf.mean(dim=dims)
        var = xf.var(dim=dims, unbiased=False)
        with torch.no_grad():
            if running_mean is not None:
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean)
            if running_var is not None:
                n = 1
                for i in dims:
                    n *= x.shape[i]
                running_var.copy_(momentum * running_var + (1 - momentum)
                                  * (var * (n / max(n - 1, 1))))
    else:
        mean, var = running_mean, running_var
    x, mean, var, *rest = amp.amp_cast_inputs(
        "batch_norm", [x, mean, var] + _present(weight, bias))
    shape = [1] * x.ndim
    shape[ch] = -1
    out = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(
        var.reshape(shape).float() + epsilon).to(x.dtype)
    return _affine(out, _split(rest, weight, bias), shape)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalize each sample's channel over its spatial axes in float32
    (the running statistics are not read, as in the reference)."""
    x, *rest = amp.amp_cast_inputs("instance_norm",
                                   [x] + _present(weight, bias))
    dims = tuple(range(2, x.ndim))
    xf = x.float()
    m = xf.mean(dim=dims, keepdim=True)
    v = xf.var(dim=dims, unbiased=False, keepdim=True)
    out = ((xf - m) * torch.rsqrt(v + eps)).to(x.dtype)
    return _affine(out, _split(rest, weight, bias),
                   [1, -1] + [1] * (x.ndim - 2))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize each of ``num_groups`` channel groups over its channels
    and spatial axes in float32; channels-last inputs are moved to
    channels-first around it."""
    channels_last = (data_format.endswith("C")
                     and not data_format.startswith("NC"))
    x, *rest = amp.amp_cast_inputs("group_norm", [x] + _present(weight, bias))
    a = x.movedim(-1, 1) if channels_last else x
    n, c = a.shape[:2]
    r = a.reshape(n, num_groups, c // num_groups, *a.shape[2:]).float()
    dims = tuple(range(2, r.ndim))
    m = r.mean(dim=dims, keepdim=True)
    v = r.var(dim=dims, unbiased=False, keepdim=True)
    out = ((r - m) * torch.rsqrt(v + epsilon)).reshape(a.shape).to(a.dtype)
    out = _affine(out, _split(rest, weight, bias),
                  [1, -1] + [1] * (a.ndim - 2))
    return out.movedim(1, -1) if channels_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * S / size) ** beta``, ``S`` the sum of squares
    over ``size`` neighbouring channels (axis 1; the reference reads no
    ``data_format``)."""
    (x,) = amp.amp_cast_inputs("local_response_norm", [x])
    c = x.shape[1]
    half = size // 2
    sq = torch.nn.functional.pad(
        x.square(), [0, 0] * (x.ndim - 2) + [half, size - 1 - half])
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq[:, i:i + c]
    return x / torch.pow(k + alpha * acc / size, beta)


__all__ = ["layer_norm", "rms_norm", "batch_norm", "instance_norm",
           "group_norm", "local_response_norm"]
