"""Core functional ops (port of ``paddle_tpu/nn/functional/common.py``):
linear, embedding, dropout, convolution, pooling, padding, resizing,
im2col, attention and the rest of that file.

Each op casts its tensor arguments by the AMP policy under the
reference's op name (``"conv2d"``, ``"pool"`` for every pooling op,
``"interpolate"``, ...), in the order the reference hands them to its
tape, then computes what the reference computes. Convolutions, pooling
windows and resizing are PyTorch's library calls (cuDNN on the card):
the reference computes them with XLA, and no Pallas kernel is involved.
Padding and window rules are the reference's (``lax`` conventions:
``"SAME"`` pads ``total // 2`` low, ``ceil_mode`` extends the high
side), applied by explicit padding before the library call.

Random ops (the dropouts, ``class_center_sample``) draw from the port's
generator of the input's device; their deterministic modes
(``training=False``, ``p=0``, ``downscale_in_infer``) compute exactly
what the reference does (ROADMAP C2).

``scaled_dot_product_attention`` keeps its three routes: the flash
kernels B1-B3 (``ops/flash_attention.py``), blocked attention, and the
dense einsum.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable
import torch.nn.functional as F

from ... import amp
from ...framework import random as prandom
from ...ops import manipulation as _manip
from ...ops.flash_attention import NEG_INF, flash_attention


def _bias(args, bias):
    """``args`` with ``bias`` appended when there is one (the reference's
    tape arguments)."""
    return args + ([bias] if bias is not None else [])


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` with Paddle's ``[in, out]`` weight (the
    port's ``nn.Linear`` keeps torch's ``[out, in]``, ROADMAP C3)."""
    x, weight, *b = amp.promote(*amp.amp_cast_inputs(
        "linear", _bias([x, weight], bias)))
    out = torch.matmul(x, weight)
    return out + b[0] if b else out


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at ids ``x``; ids equal to ``padding_idx`` give
    zeros (and no gradient)."""
    (weight,) = amp.amp_cast_inputs("embedding", [weight])
    idx = torch.as_tensor(x, device=weight.device)
    out = F.embedding(idx, weight)
    if padding_idx is not None:
        out = torch.where((idx == padding_idx)[..., None], 0.0, out)
    return out


def one_hot(x, num_classes, name=None):
    amp.amp_cast_inputs("one_hot", [x])
    return _manip.one_hot(x, num_classes)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _keep(shape, p, device):
    """A bool mask, True with probability ``1 - p``."""
    return torch.rand(shape, device=device,
                      generator=prandom.generator(device)) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero elements with probability ``p`` (whole slices along the axes
    not in ``axis``, when given); ``upscale_in_train`` scales the kept
    ones by ``1 / (1 - p)``, ``downscale_in_infer`` scales by ``1 - p``
    outside training instead."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            (x,) = amp.amp_cast_inputs("dropout", [x])
            return x * (1.0 - p)
        return x
    (x,) = amp.amp_cast_inputs("dropout", [x])
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep(shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_drop(x, p, mask_shape, op):
    (x,) = amp.amp_cast_inputs(op, [x])
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = _keep(mask_shape, p, x.device)
    q = 1.0 - p
    a = (q + alpha_p ** 2 * q * p) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take ``-alpha * scale``,
    then an affine map keeps mean and variance."""
    if not training or p == 0.0:
        return x
    return _alpha_drop(x, p, x.shape, "alpha_dropout")


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """``alpha_dropout`` over whole channels (``[N, C, 1, ...]``
    masks)."""
    if not training or p == 0.0:
        return x
    return _alpha_drop(x, p, x.shape[:2] + (1,) * (x.ndim - 2),
                       "feature_alpha_dropout")


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def _conv_padding(padding, nd):
    """Paddle's padding (an int, one per axis, two per axis, pairs, or
    ``"SAME"`` / ``"VALID"``) -> ``[(low, high)] * nd`` or the string."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    pads = list(padding)
    if len(pads) == nd and all(isinstance(p, int) for p in pads):
        return [(p, p) for p in pads]
    if len(pads) == 2 * nd:
        return [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]
    return [tuple(p) for p in pads]


def _same_pads(spatial, window, strides):
    """``lax``'s ``"SAME"``: output ``ceil(in / stride)``, the padding it
    needs split ``total // 2`` low, the rest high."""
    out = []
    for n, w, s in zip(spatial, window, strides):
        total = max((-(-n // s) - 1) * s + w - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _resolve(padding, spatial, window, strides):
    if padding == "SAME":
        return _same_pads(spatial, window, strides)
    if padding == "VALID":
        return [(0, 0)] * len(spatial)
    return padding


def _flat(pads):
    """``[(low, high)]`` per spatial axis -> ``F.pad``'s list (last axis
    first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_nd(x, weight, bias, nd, stride, padding, dilation, groups,
             channels_last, op):
    """Convolution with Paddle's ``[out_c, in_c / groups, *k]`` weight;
    channels-last inputs are moved to channels-first around it."""
    x, weight, *b = amp.promote(*amp.amp_cast_inputs(
        op, _bias([x, weight], bias)))
    if channels_last:
        x = x.movedim(-1, 1)
    strides, dil = _tuple(stride, nd), _tuple(dilation, nd)
    window = [d * (k - 1) + 1 for d, k in zip(dil, weight.shape[2:])]
    pads = _resolve(_conv_padding(padding, nd), x.shape[2:], window, strides)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[nd](x, weight, None, strides, [lo for lo, _ in pads],
                        dil, groups)
    else:
        out = _CONV[nd](F.pad(x, _flat(pads)), weight, None, strides, 0, dil,
                        groups)
    if b:
        out = out + b[0].reshape([1, -1] + [1] * nd)
    return out.movedim(1, -1) if channels_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, 1, stride, padding, dilation, groups,
                    data_format != "NCL", "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, 2, stride, padding, dilation, groups,
                    data_format != "NCHW", "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, 3, stride, padding, dilation, groups,
                    False, "conv3d")


def _conv_transpose_nd(x, weight, bias, nd, stride, padding, output_padding,
                       groups, dilation, output_size, op_name):
    """Transposed convolution with Paddle's ``[in_c, out_c / groups, *k]``
    weight, as the reference's gradient-style ``lax`` convolution: the
    input dilated by ``stride``, padded ``dilation * (k - 1) - low`` and
    ``dilation * (k - 1) - high + output_padding``. PyTorch's transposed
    convolution without padding is that convolution padded
    ``dilation * (k - 1)`` on both sides; the difference is cropped (or
    padded with zeros) after it. ``output_size`` sets the output padding
    of each axis."""
    strides, dil = _tuple(stride, nd), _tuple(dilation, nd)
    opad = list(_tuple(output_padding, nd))
    ks = weight.shape[2:]
    if output_size is not None:
        if isinstance(padding, str):
            raise NotImplementedError(
                "output_size with string padding is unsupported")
        if hasattr(output_size, "tolist"):
            output_size = output_size.tolist()
        out_sp = [int(s) for s in tuple(output_size)[-nd:]]
        p = _conv_padding(padding, nd)
        for i in range(nd):
            base = ((int(x.shape[2 + i]) - 1) * strides[i] - p[i][0]
                    - p[i][1] + dil[i] * (int(ks[i]) - 1) + 1)
            extra = out_sp[i] - base
            if extra < 0 or extra >= strides[i] + max(0, dil[i] - 1):
                raise ValueError(f"output_size[{i}]={out_sp[i]} unreachable "
                                 f"(base {base}, stride {strides[i]})")
            opad[i] = extra
    x, weight, *b = amp.promote(*amp.amp_cast_inputs(
        op_name, _bias([x, weight], bias)))
    full = [d * (k - 1) for d, k in zip(dil, ks)]
    if isinstance(padding, str):
        dilated = [(n - 1) * s + 1 for n, s in zip(x.shape[2:], strides)]
        pads = _resolve(padding.upper(), dilated, [f + 1 for f in full],
                        [1] * nd)
    else:
        pads = [(f - lo, f - hi + o) for f, (lo, hi), o in
                zip(full, _conv_padding(padding, nd), opad)]
    out = _CONV_T[nd](x, weight, None, strides, 0, 0, groups, dil)
    out = F.pad(out, _flat([(lo - f, hi - f)
                            for (lo, hi), f in zip(pads, full)]))
    if b:
        out = out + b[0].reshape([1, -1] + [1] * nd)
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, 2, stride, padding,
                              output_padding, groups, dilation, output_size,
                              "conv2d_transpose")


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _window_sum(a, ksize, strides):
    """Sums over windows (no padding): PyTorch's average pooling with a
    divisor of 1, a 1-D window as a 2-D one of height 1."""
    if len(ksize) == 1:
        return F.avg_pool2d(a.unsqueeze(2), (1, ksize[0]), (1, strides[0]),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(ksize) == 2 else F.avg_pool3d
    return pool(a, ksize, strides, divisor_override=1)


def _pool(x, ksize, strides, padding, kind, data_format="NCHW",
          ceil_mode=False, count_include_pad=True):
    """The reference's ``reduce_window`` pooling, op ``"pool"``: ``kind``
    is ``"max"`` (pads with -inf), ``"sum"`` or ``"avg"`` (pads with 0).
    ``ceil_mode`` extends the high side so a last partial window is kept.
    An average divides by the window's real elements, and the user's
    padding too when ``count_include_pad``."""
    (x,) = amp.amp_cast_inputs("pool", [x])
    nd = len(ksize)
    channels_first = data_format in ("NCHW", "NCL", "NCDHW")
    a = x if channels_first else x.movedim(-1, 1)
    spatial = a.shape[2:]
    spad = (_resolve(padding.upper(), spatial, ksize, strides)
            if isinstance(padding, str) else [tuple(p) for p in padding])
    counted = list(spad)
    if ceil_mode:
        for i in range(nd):
            rem = (spatial[i] + spad[i][0] + spad[i][1] - ksize[i]) \
                % strides[i]
            if rem:
                spad[i] = (spad[i][0], spad[i][1] + strides[i] - rem)
    if kind == "max":
        out = _MAX_POOL[nd](F.pad(a, _flat(spad), value=float("-inf")),
                            ksize, strides)
    else:
        out = _window_sum(F.pad(a, _flat(spad)), ksize, strides)
    if kind == "avg":
        if count_include_pad and not ceil_mode and all(
                p == (0, 0) for p in spad):
            out = out / float(np.prod(ksize))
        else:
            ones = torch.ones_like(a)
            if count_include_pad:
                ones = F.pad(ones, _flat(counted), value=1.0)
                ones = F.pad(ones, _flat([(p[0] - c[0], p[1] - c[1])
                                          for p, c in zip(spad, counted)]))
            else:
                ones = F.pad(ones, _flat(spad))
            out = out / _window_sum(ones, ksize, strides)
    return out if channels_first else out.movedim(1, -1)


def _pool_args(kernel_size, stride, padding, nd):
    ksize = _tuple(kernel_size, nd)
    strides = _tuple(stride, nd) if stride is not None else ksize
    pad = padding if isinstance(padding, str) else _conv_padding(padding, nd)
    return ksize, strides, pad


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 2)
    if return_mask:
        from .extras import _check_index_pool_args, _max_pool_with_index
        _check_index_pool_args(padding, ceil_mode, data_format, "NCHW")
        return _max_pool_with_index(x, ksize, strides, _tuple(padding, 2))
    return _pool(x, ksize, strides, pad, "max", data_format, ceil_mode)


def _avg_pool(x, ksize, strides, pad, data_format, ceil_mode, exclusive,
              divisor_override):
    """Window sums over ``divisor_override`` when given (op
    ``"avg_pool_divisor"`` after ``"pool"``), else the mean by the
    ``exclusive`` rule."""
    if divisor_override:
        sums = _pool(x, ksize, strides, pad, "sum", data_format, ceil_mode)
        (sums,) = amp.amp_cast_inputs("avg_pool_divisor", [sums])
        return sums / float(divisor_override)
    return _pool(x, ksize, strides, pad, "avg", data_format, ceil_mode,
                 count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 2)
    return _avg_pool(x, ksize, strides, pad, data_format, ceil_mode,
                     exclusive, divisor_override)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 1)
    if return_mask:
        from .extras import _check_index_pool_args, _max_pool_with_index
        _check_index_pool_args(padding, ceil_mode, "NCL", "NCL")
        return _max_pool_with_index(x, ksize, strides, _tuple(padding, 1))
    return _pool(x, ksize, strides, pad, "max", "NCL", ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 1)
    return _pool(x, ksize, strides, pad, "avg", "NCL", ceil_mode,
                 count_include_pad=not exclusive)


def _bins(n, m):
    """Adaptive pooling's bins of ``n`` into ``m``: ``[floor(i n / m),
    ceil((i + 1) n / m))``."""
    return [((i * n) // m, -((-(i + 1) * n) // m)) for i in range(m)]


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Means over ``output_size`` bins (a reshape when they divide the
    input evenly, PyTorch's adaptive pooling, whose bins are the same,
    otherwise)."""
    (x,) = amp.amp_cast_inputs("adaptive_avg_pool2d", [x])
    out_hw = _tuple(output_size, 2)
    a = x if data_format == "NCHW" else x.movedim(-1, 1)
    n, c, h, w = a.shape
    oh, ow = out_hw[0] or h, out_hw[1] or w
    if h % oh == 0 and w % ow == 0:
        out = a.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    else:
        out = F.adaptive_avg_pool2d(a, (oh, ow))
    return out if data_format == "NCHW" else out.movedim(1, -1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Maxima over ``output_size`` bins that divide the input evenly (the
    reference supports no other; it returns no mask either)."""
    (x,) = amp.amp_cast_inputs("adaptive_max_pool2d", [x])
    out_hw = _tuple(output_size, 2)
    n, c, h, w = x.shape
    oh, ow = out_hw[0] or h, out_hw[1] or w
    if h % oh or w % ow:
        raise NotImplementedError(
            "adaptive_max_pool2d with non-divisible sizes")
    return x.reshape(n, c, oh, h // oh, ow, w // ow).amax(dim=(3, 5))


def adaptive_avg_pool1d(x, output_size, name=None):
    (x,) = amp.amp_cast_inputs("adaptive_avg_pool1d", [x])
    n, c, length = x.shape
    if length % output_size:
        raise NotImplementedError(
            "adaptive_avg_pool1d with non-divisible sizes")
    return x.reshape(n, c, output_size, length // output_size).mean(dim=3)


# ---------------------------------------------------------------------------
# padding / resizing
# ---------------------------------------------------------------------------

def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.pad`` (``ops/manipulation.py``), the reference's op
    ``"pad"``."""
    (x,) = amp.amp_cast_inputs("pad", [x])
    return _manip.pad(x, pad, mode, value, data_format)


def _bilinear_align_corners(a, oh, ow):
    """Bilinear resize on the ``align_corners`` grid (source ``i (H - 1)
    / (OH - 1)``), in ``a``'s dtype."""
    h, w = a.shape[2], a.shape[3]
    ys = torch.linspace(0.0, h - 1.0, oh, device=a.device)
    xs = torch.linspace(0.0, w - 1.0, ow, device=a.device)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp_max(h - 1), (x0 + 1).clamp_max(w - 1)
    wy = (ys - y0).to(a.dtype)[:, None]
    wx = (xs - x0).to(a.dtype)[None, :]
    rows0, rows1 = a[:, :, y0], a[:, :, y1]
    top = rows0[..., x0] * (1 - wx) + rows0[..., x1] * wx
    bot = rows1[..., x0] * (1 - wx) + rows1[..., x1] * wx
    return top * (1 - wy) + bot * wy


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of a 3-D or 4-D input to ``size`` (or
    ``int(n * scale_factor)``): ``"nearest"`` takes source ``i * n //
    out``; ``"bilinear"`` / ``"linear"`` use half-pixel centres, or the
    corner grid with ``align_corners`` (and more than one output row and
    column); ``"bicubic"`` the Keys cubic with ``a = -0.5``. Linear and
    cubic resizes that shrink an axis low-pass filter it first, as the
    reference's ``jax.image.resize`` does (PyTorch's ``antialias``)."""
    if x.ndim == 3:
        # a 3-D input as a 4-D one of height 1 (the reference's
        # ``unsqueeze`` and ``squeeze`` ops around it)
        chan_last = data_format in ("NWC", "NLC")
        (x,) = amp.amp_cast_inputs("unsqueeze", [x])
        xs = x.unsqueeze(1 if chan_last else 2)
        size2 = ([1, int(size[0] if isinstance(size, (list, tuple))
                         else size)] if size is not None else None)
        sf = scale_factor
        if sf is not None:
            sf = [1, sf[0] if isinstance(sf, (list, tuple)) else sf]
        mode2 = "bilinear" if mode == "linear" else mode
        out = interpolate(xs, size2, sf, mode2, align_corners, align_mode,
                          "NHWC" if chan_last else "NCHW")
        (out,) = amp.amp_cast_inputs("squeeze", [out])
        return out.squeeze(1 if chan_last else 2)
    (x,) = amp.amp_cast_inputs("interpolate", [x])
    a = x if data_format == "NCHW" else x.movedim(-1, 1)
    h, w = a.shape[2], a.shape[3]
    if size is not None:
        oh, ow = int(size[0]), int(size[1])
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor, scale_factor])
        oh, ow = int(h * sf[0]), int(w * sf[1])
    if mode == "nearest":
        rows = torch.arange(oh, device=a.device) * h // oh
        cols = torch.arange(ow, device=a.device) * w // ow
        out = a[:, :, rows][:, :, :, cols]
    elif mode in ("bilinear", "linear") and align_corners and oh > 1 \
            and ow > 1:
        out = _bilinear_align_corners(a, oh, ow)
    elif mode in ("bilinear", "linear", "bicubic"):
        # the filtered resize in fp32 (PyTorch's CPU kernel has no 16-bit
        # one), rounded back to the input's dtype
        out = F.interpolate(a.float(), size=(oh, ow),
                            mode="bicubic" if mode == "bicubic"
                            else "bilinear", align_corners=False,
                            antialias=True).to(a.dtype)
    else:
        raise NotImplementedError(mode)
    return out if data_format == "NCHW" else out.movedim(1, -1)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[n, c r^2, h, w] -> [n, c, h r, w r]`` (channels-first; the
    reference reads no ``data_format``)."""
    (x,) = amp.amp_cast_inputs("pixel_shuffle", [x])
    r = upscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    (x,) = amp.amp_cast_inputs("channel_shuffle", [x])
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[n, c, h, w] -> [n, c * kh * kw, L]``, channel-major
    patches (not ``paddle.unfold``'s sliding windows of one axis)."""
    (x,) = amp.amp_cast_inputs("unfold", [x])
    ks, st = _tuple(kernel_sizes, 2), _tuple(strides, 2)
    pd, dl = _tuple(paddings, 2), _tuple(dilations, 2)
    return F.unfold(x, ks[:2], dl[:2], pd[:2], st[:2])


def unfold_channels(x, kernel_sizes, strides=1, paddings=0, dilations=1,
                    name=None):
    """:func:`unfold` under the name of the reference's channels
    variant (the same layout)."""
    return unfold(x, kernel_sizes, strides=strides, paddings=paddings,
                  dilations=dilations, name=name)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding ``[left, right, top, bottom]``."""
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    (label,) = amp.amp_cast_inputs("label_smooth", [label])
    prior = 1.0 / label.shape[-1] if prior_dist is None else prior_dist
    return (1.0 - epsilon) * label + epsilon * prior


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    (x,) = amp.amp_cast_inputs("normalize", [x])
    nrm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(nrm, min=epsilon)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] (+ bias[o])``."""
    x1, x2, weight, *b = amp.promote(*amp.amp_cast_inputs(
        "bilinear", _bias([x1, x2, weight], bias)))
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out + b[0] if b else out


def class_center_sample(label, num_classes, num_samples, group=None):
    """The positive classes of ``label`` plus random negatives up to
    ``num_samples``: returns ``(remapped label, sampled class ids)``, both
    int32, the positives sorted first, then the negatives sorted. The
    negatives come from a numpy permutation seeded from the port's
    generator of the label's device (host-side, as in the reference)."""
    dev = label.device if isinstance(label, torch.Tensor) else None
    yv = (label.detach().cpu().numpy() if isinstance(label, torch.Tensor)
          else np.asarray(label)).reshape(-1)
    pos = np.unique(yv)
    n_extra = max(int(num_samples) - pos.size, 0)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    if n_extra > 0 and rest.size:
        gen_dev = dev if dev is not None else torch.device("cpu")
        seed = int(torch.randint(0, 2 ** 31 - 1, (), device=gen_dev,
                                 generator=prandom.generator(gen_dev)))
        extra = np.random.default_rng(seed).permutation(rest)[:n_extra]
        sampled = np.concatenate([pos, np.sort(extra)])
    else:
        sampled = pos
    remap = np.full(num_classes, -1, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (torch.as_tensor(remap[yv].astype(np.int32), device=dev),
            torch.as_tensor(sampled.astype(np.int32), device=dev))


def sparse_attention(query, key, value, sparse_csr_offset=None,
                     sparse_csr_columns=None, sparse_mask=None,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention over ``[b, h, s, d]`` restricted to a per-(batch, head)
    CSR pattern (``offset [b, h, s + 1]``, ``columns [b, h, nnz]``) or a
    dense / sparse ``sparse_mask``, with an optional ``key_padding_mask
    [b, s]`` (0 drops a key) and an additive ``attn_mask [s, s]``. The
    pattern becomes a dense mask over one fp32 softmax; a row with no
    allowed key gives zeros."""
    def host(t):
        if isinstance(t, torch.Tensor):
            t = t.to_dense() if t.is_sparse or t.layout != torch.strided \
                else t
            return t.detach().cpu().numpy()
        return np.asarray(t)

    b, h, s, _ = query.shape
    if sparse_mask is not None:
        allowed = host(sparse_mask).reshape(b, h, s, s) != 0
    elif sparse_csr_offset is not None and sparse_csr_columns is not None:
        offs = host(sparse_csr_offset).reshape(b, h, s + 1).astype(np.int64)
        cols = host(sparse_csr_columns).reshape(b, h, -1).astype(np.int64)
        allowed = np.zeros((b, h, s, s), bool)
        j = np.arange(cols.shape[-1])
        rows = (offs[..., None, 1:-1] <= j[:, None]).sum(-1)
        bi, hi, ji = np.nonzero(j < offs[..., -1:])
        allowed[bi, hi, rows[bi, hi, ji], cols[bi, hi, ji]] = True
    else:
        raise ValueError("sparse_attention needs sparse_mask or CSR "
                         "offset+columns")
    if key_padding_mask is not None:
        keep = host(key_padding_mask).astype(bool)
        allowed = allowed & keep[:, None, None, :]
    dev = query.device
    allowed_t = torch.as_tensor(allowed, device=dev)
    dead = ~allowed_t.any(-1)
    q, k, v = amp.amp_cast_inputs("sparse_attention", [query, key, value])
    lg = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / (q.shape[-1] ** 0.5)
    if attn_mask is not None:
        lg = lg + torch.as_tensor(host(attn_mask), dtype=torch.float32,
                                  device=dev)
    lg = torch.where(allowed_t, lg, -1e30)
    w = torch.where(dead[..., None], 0.0, torch.softmax(lg, dim=-1))
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


#: the reference's long-sequence thresholds (``common.py:615-617``): one
#: logits plane of at least 4096 x 4096, or at least 1 GiB of fp32
#: logits in all
CHUNKED_SEQ_PRODUCT = 4096 * 4096
CHUNKED_LOGITS_BYTES = 1 << 30
#: the chunked route's blocks: ``_xfa_blocks``'s defaults
#: (``flash_attention.py:520-523``)
CHUNK_Q, CHUNK_K = 512, 1024


def sdpa_route(q_shape, k_shape, has_mask=False, dropout=False):
    """The reference op a call takes, from shapes ``[b, s, h, d]`` alone:
    ``"flash_attn"`` with no mask, no active dropout, ``seq_q >= 128`` and
    ``head_dim % 64 == 0`` (``:583-588``; the reference also needs a TPU
    backend and ``FLAGS_use_flash_attention``, the port takes it on every
    device and has no flag); else ``"sdpa_chunked"`` with no mask, no
    active dropout, ``seq_q > 1`` and a large logits plane (``:609-617``);
    else ``"sdpa"``."""
    b, sq, hq, d = q_shape
    sk = k_shape[1]
    plain = not has_mask and not dropout
    if plain and sq >= 128 and d % 64 == 0:
        return "flash_attn"
    if plain and sq > 1 and (sq * sk >= CHUNKED_SEQ_PRODUCT
                             or b * hq * sq * sk * 4 >= CHUNKED_LOGITS_BYTES):
        return "sdpa_chunked"
    return "sdpa"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors, with
    grouped-query heads (``key`` may have fewer heads than ``query``) and
    bottom-right causal alignment when ``seq_q != seq_k``. The route
    (:func:`sdpa_route`) names the op whose AMP policy casts the inputs:

    * ``"flash_attn"``: :func:`flash_attention` with query ``i`` at
      position ``seq_k - seq_q + i`` (the kernels B1, B2, B3 on a CUDA
      tensor, their plain versions on a CPU one). Inputs of mixed dtypes
      compute as the Pallas kernel does, which casts q, k and v to fp32
      (``flash_attention.py:141-143``): all go up exactly, the fp32
      kernels run, the output comes back in q's dtype and each gradient
      in its input's.
    * ``"sdpa_chunked"``: :func:`chunked_attention`, the counterpart of
      ``xla_attention``: plain torch, blocks of queries and keys, no
      ``seq_q x seq_k`` logits plane forward or backward.
    * ``"sdpa"``: the grouped einsum with the softmax in fp32; a bool
      ``attn_mask`` keeps the keys where it is True (the rest ``-inf``), a
      float one is added to the logits; with ``dropout_p > 0`` and
      ``training`` the weights are kept with probability ``1 - dropout_p``
      and scaled by ``1 / (1 - dropout_p)``, drawn from ``generator`` (a
      ``torch.Generator``; None: PyTorch's default one for the device).
      The reference draws from its JAX key stream; the port's draws
      reproduce within the port only (ROADMAP C2). Differentiated by
      autograd.
    """
    dropout = dropout_p > 0.0 and training
    route = sdpa_route(query.shape, key.shape, attn_mask is not None,
                       dropout)
    sq = query.shape[1]
    if route == "flash_attn":
        q, k, v = amp.amp_cast_inputs("flash_attn", [query, key, value])
        dt = q.dtype
        if not q.dtype == k.dtype == v.dtype:
            q, k, v = q.float(), k.float(), v.float()
        return flash_attention(q, k, v, causal=is_causal,
                               q_offset=key.shape[1] - sq).to(dt)
    if route == "sdpa_chunked":
        q, k, v = amp.amp_cast_inputs("sdpa_chunked", [query, key, value])
        q_off = key.shape[1] - sq if is_causal else 0
        return chunked_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=is_causal,
            q_offset=q_off).transpose(1, 2)
    args = amp.amp_cast_inputs("sdpa", [query, key, value] + (
        [attn_mask] if attn_mask is not None else []))
    q, k, v = args[:3]
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, hq = qt.shape[:2]
    hk, sk = kt.shape[1], kt.shape[2]
    qg = qt.reshape(b, hk, hq // hk, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", *amp.promote(qg, kt)) * scale
    logits = logits.reshape(b, hq, sq, sk)
    if is_causal:
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if len(args) > 3:
        mask = args[3]
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, float("-inf"))
        else:
            logits = torch.add(*amp.promote(logits, mask))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    pg = probs.reshape(b, hk, hq // hk, sq, sk)
    out = torch.einsum("bhgqk,bhkd->bhgqd", *amp.promote(pg, vt))
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def _blocks(sq, sk, block_q, block_k, causal, q_offset):
    """The chunked route's (q block, k block) visits: every k block of
    each q block, but those wholly in its causal future (they weigh 0
    and leave the running max, sum and output exactly as they were)."""
    bq, bk = min(block_q, sq), min(block_k, sk)
    for i in range(0, sq, bq):
        rows = min(bq, sq - i)
        last = q_offset + i + rows - 1
        yield i, rows, [(j, min(bk, sk - j)) for j in range(0, sk, bk)
                        if not causal or j <= last]


def _scores(qi, kf, i, j, cols, causal, q_offset, scale):
    s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kf[:, :, j:j + cols]) * scale
    if causal:
        qpos = q_offset + i + torch.arange(qi.shape[3], device=qi.device)
        kpos = j + torch.arange(cols, device=qi.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    return s


def _chunked_fwd(q, k, v, causal, q_offset, block_q, block_k):
    """``_xflash_fwd_impl`` (``flash_attention.py:526``) in kernel layout
    ``[b, h, s, d]``: online softmax over k blocks for each q block, the
    scores in fp32, the weights rounded to v's dtype before ``P V`` (fp32
    sums), rows with no valid key give 0 and lse ``NEG_INF``. Returns
    ``(out in q's dtype, lse fp32 [b, hq, sq])``."""
    b, hq, sq, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hk, g, sq, d)
    kf, vf = k.float(), v.float()
    out = torch.empty(b, hk, g, sq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hk, g, sq, dtype=torch.float32, device=q.device)
    for i, rows, visits in _blocks(sq, k.shape[2], block_q, block_k, causal,
                                   q_offset):
        qi = qg[:, :, :, i:i + rows].float()
        m = torch.full((b, hk, g, rows), NEG_INF, device=q.device)
        m_eff = torch.zeros_like(m)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hk, g, rows, d, device=q.device)
        for j, cols in visits:
            s = _scores(qi, kf, i, j, cols, causal, q_offset, scale)
            m_new = torch.maximum(m, s.amax(-1))
            m_eff = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_eff[..., None])
            alpha = torch.exp(m - m_eff)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                              vf[:, :, j:j + cols])
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        out[:, :, :, i:i + rows] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, :, :, i:i + rows] = torch.where(
            l <= 1e-30, NEG_INF, m_eff + torch.log(l_safe))
    return out.reshape(b, hq, sq, d), lse.reshape(b, hq, sq)


def _chunked_bwd(q, k, v, out, lse, dout, causal, q_offset, block_q,
                 block_k):
    """``_xflash_bwd_impl`` (``flash_attention.py:586``): the weights
    recomputed from lse block by block, ``ds = p (dp - delta) scale``, p
    rounded to v's dtype and ds to q's before their products, fp32 sums;
    each gradient in its input's dtype."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hk, g, sq, d)
    dog = dout.reshape(b, hk, g, sq, d)
    lseg = lse.reshape(b, hk, g, sq)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, hk, g, sq)
    kf, vf = k.float(), v.float()
    dq = torch.empty(b, hk, g, sq, d, dtype=q.dtype, device=q.device)
    dk = torch.zeros(b, hk, sk, d, device=q.device)
    dv = torch.zeros(b, hk, sk, d, device=q.device)
    for i, rows, visits in _blocks(sq, sk, block_q, block_k, causal,
                                   q_offset):
        qi = qg[:, :, :, i:i + rows].float()
        doi = dog[:, :, :, i:i + rows].float()
        lse_i = lseg[:, :, :, i:i + rows, None]
        live = (lse_i > NEG_INF / 2).float()
        delta_i = delta[:, :, :, i:i + rows, None]
        dq_i = torch.zeros(b, hk, g, rows, d, device=q.device)
        for j, cols in visits:
            s = _scores(qi, kf, i, j, cols, causal, q_offset, scale)
            p = torch.exp(s - lse_i) * live
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doi, vf[:, :, j:j + cols])
            ds = p * (dp - delta_i) * scale
            pc = p.to(v.dtype).float()
            dsc = ds.to(q.dtype).float()
            dq_i += torch.einsum("bhgqk,bhkd->bhgqd", dsc,
                                 kf[:, :, j:j + cols])
            dk[:, :, j:j + cols] += torch.einsum("bhgqk,bhgqd->bhkd", dsc, qi)
            dv[:, :, j:j + cols] += torch.einsum("bhgqk,bhgqd->bhkd", pc, doi)
        dq[:, :, :, i:i + rows] = dq_i.to(q.dtype)
    return dq.reshape(b, hq, sq, d), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_q, block_k):
        out, lse = _chunked_fwd(q, k, v, causal, q_offset, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_q, block_k)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_chunked_bwd(q, k, v, out, lse, dout, *ctx.args),
                None, None, None, None)


def chunked_attention(q, k, v, causal=True, q_offset=0, block_q=CHUNK_Q,
                      block_k=CHUNK_K):
    """Kernel-layout ``[b, h, s, d]`` attention in blocks of ``block_q``
    queries by ``block_k`` keys (the reference's ``xla_attention`` tier
    ``_xflash``; a ragged last block where the reference's tier would
    fall back to its q-chunked one, the same function). The largest
    temporary is one block's ``[b, h, block_q, block_k]`` fp32 scores,
    forward and backward. Differentiable in q, k and v."""
    return _ChunkedAttention.apply(q, k, v, bool(causal), int(q_offset),
                                   int(block_q), int(block_k))


__all__ = ["linear", "embedding", "one_hot", "dropout", "dropout2d",
           "dropout3d", "alpha_dropout", "feature_alpha_dropout", "conv1d",
           "conv2d", "conv3d", "conv2d_transpose", "max_pool1d",
           "max_pool2d", "avg_pool1d", "avg_pool2d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d", "pad",
           "interpolate", "upsample", "pixel_shuffle", "channel_shuffle",
           "unfold", "unfold_channels", "zeropad2d", "label_smooth",
           "normalize", "bilinear", "class_center_sample",
           "sparse_attention", "scaled_dot_product_attention", "sdpa_route",
           "chunked_attention", "CHUNKED_SEQ_PRODUCT",
           "CHUNKED_LOGITS_BYTES", "CHUNK_Q", "CHUNK_K"]
