"""The rest of the functional surface (port of
``paddle_tpu/nn/functional/extras.py``): 3-D pooling, pooling with
indices and unpooling, 1-D and 3-D transposed convolutions, the vision
ops (``fold``, ``affine_grid``, ``grid_sample``, ``pixel_unshuffle``,
``temporal_shift``), ``sequence_mask``, ``gather_tree`` and the last
losses."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ... import amp
from ...framework import dtype as dtypes
from .common import (_avg_pool, _conv_transpose_nd, _pool, _pool_args,
                     _tuple)
from .loss import _norm, _reduce


# ---------------------------------------------------------------------------
# pooling: 3-D, indices, unpooling
# ---------------------------------------------------------------------------

def _check_index_pool_args(padding, ceil_mode, data_format, expect_df):
    if isinstance(padding, str):
        raise NotImplementedError(
            "return_mask pooling: string padding unsupported (use ints)")
    if ceil_mode:
        raise NotImplementedError("return_mask pooling: ceil_mode unsupported")
    if data_format != expect_df:
        raise NotImplementedError(
            f"return_mask pooling: only {expect_df} layout")


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 3)
    if return_mask:
        _check_index_pool_args(padding, ceil_mode, data_format, "NCDHW")
        return _max_pool_with_index(x, ksize, strides, _tuple(padding, 3))
    return _pool(x, ksize, strides, pad, "max", data_format, ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    ksize, strides, pad = _pool_args(kernel_size, stride, padding, 3)
    return _avg_pool(x, ksize, strides, pad, data_format, ceil_mode,
                     exclusive, divisor_override)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Means over adaptive bins (a reshape when they divide the input)."""
    if data_format != "NCDHW":
        raise NotImplementedError("adaptive_avg_pool3d: NCDHW only")
    (x,) = amp.amp_cast_inputs("adaptive_avg_pool3d", [x])
    n, c, d, h, w = x.shape
    sizes = _tuple(output_size, 3)
    od, oh, ow = sizes[0] or d, sizes[1] or h, sizes[2] or w
    if d % od == 0 and h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow).mean(
            dim=(3, 5, 7))
    return F.adaptive_avg_pool3d(x, (od, oh, ow))


def _max_pool_with_index(x, ksize, strides, pads):
    """Window maxima and their flat spatial indices into the unpadded
    input (the mask ``max_unpool*`` reads), op ``"max_pool_index"``: every
    window offset's strided view of the -inf padded input, stacked in
    row-major kernel order, the first maximum kept."""
    (x,) = amp.amp_cast_inputs("max_pool_index", [x])
    nd = len(ksize)
    spatial = x.shape[2:]
    padded = F.pad(x, [p for q in reversed(pads) for p in (q, q)],
                   value=float("-inf"))
    outs = [(padded.shape[2 + i] - ksize[i]) // strides[i] + 1
            for i in range(nd)]
    windows, flat_idx = [], []
    for off in np.ndindex(*ksize):
        sl = [slice(None), slice(None)] + [
            slice(off[i], off[i] + outs[i] * strides[i], strides[i])
            for i in range(nd)]
        windows.append(padded[tuple(sl)])
        flat = torch.zeros([1] * nd, dtype=torch.long, device=x.device)
        mult = 1
        for i in reversed(range(nd)):
            shape = [1] * nd
            shape[i] = outs[i]
            pos = (torch.arange(outs[i], device=x.device) * strides[i]
                   + off[i] - pads[i])
            flat = flat + pos.reshape(shape) * mult
            mult *= spatial[i]
        flat_idx.append(flat.expand(outs))
    stack = torch.stack(windows, dim=-1)
    idxs = torch.stack(flat_idx, dim=-1).expand(stack.shape)
    arg = stack.argmax(dim=-1, keepdim=True)
    return (stack.gather(-1, arg)[..., 0],
            idxs.gather(-1, arg)[..., 0].to(torch.int32))


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0):
    ksize = _tuple(kernel_size, 2)
    strides = _tuple(stride, 2) if stride is not None else ksize
    return _max_pool_with_index(x, ksize, strides, _tuple(padding, 2))


def max_pool1d_with_index(x, kernel_size, stride=None, padding=0):
    ksize = _tuple(kernel_size, 1)
    strides = _tuple(stride, 1) if stride is not None else ksize
    return _max_pool_with_index(x, ksize, strides, _tuple(padding, 1))


def _max_unpool(x, indices, nd, kernel_size, stride, padding, output_size,
                data_format):
    """Values scattered to their flat spatial ``indices`` in a zero output
    of ``output_size`` (default ``(in - 1) * stride - 2 * pad + k``); an
    index past the output raises."""
    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise NotImplementedError(
            f"max_unpool: channels-first only (got {data_format})")
    ksize = _tuple(kernel_size, nd)
    strides = _tuple(stride, nd) if stride is not None else ksize
    pads = _tuple(padding, nd)
    a, idx = amp.amp_cast_inputs("max_unpool", [x, indices])
    n, c = a.shape[:2]
    if output_size is not None:
        out_sp = tuple(int(s) for s in tuple(output_size)[-nd:])
    else:
        out_sp = tuple((a.shape[2 + i] - 1) * strides[i] - 2 * pads[i]
                       + ksize[i] for i in range(nd))
    total = int(np.prod(out_sp))
    ii = idx.reshape(n, c, -1).long()
    hi = int(ii.max()) if ii.numel() else 0
    if hi >= total:
        raise ValueError(f"max_unpool: index {hi} out of range for output "
                         f"size {out_sp} ({total} elements) — pass a larger "
                         f"output_size")
    flat = torch.zeros((n, c, total), dtype=a.dtype, device=a.device)
    flat = flat.scatter(2, ii, a.reshape(n, c, -1))
    return flat.reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size, data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size, data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size, data_format)


# ---------------------------------------------------------------------------
# transposed convolutions (1-D, 3-D)
# ---------------------------------------------------------------------------

def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, 1, stride, padding,
                              output_padding, groups, dilation, output_size,
                              "conv1d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose_nd(x, weight, bias, 3, stride, padding,
                              output_padding, groups, dilation, output_size,
                              "conv3d_transpose")


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------

def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    if data_format != "NCHW":
        raise NotImplementedError("pixel_unshuffle: NCHW only")
    (x,) = amp.amp_cast_inputs("pixel_unshuffle", [x])
    r = int(downscale_factor)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of ``unfold`` (overlapping patches add)."""
    (x,) = amp.amp_cast_inputs("fold", [x])
    out_hw = _tuple(output_sizes, 2)
    ks, st = _tuple(kernel_sizes, 2), _tuple(strides, 2)
    pd, dl = _tuple(paddings, 2), _tuple(dilations, 2)
    return F.fold(x, out_hw[:2], ks[:2], dl[:2], pd[:2], st[:2])


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta [N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]`` (x, y in
    [-1, 1])."""
    if hasattr(out_shape, "tolist"):
        out_shape = out_shape.tolist()
    _, _, h, w = [int(s) for s in out_shape]
    (th,) = amp.amp_cast_inputs("affine_grid", [theta])
    dev = th.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) + 0.5) * 2.0 / w - 1.0
        ys = (torch.arange(h, device=dev) + 0.5) * 2.0 / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(th.dtype)
    return torch.einsum("hwk,nok->nhwo", base, th)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x [N, C, H, W]`` at ``grid [N, Ho, Wo, 2]`` (normalized x,
    y) -> ``[N, C, Ho, Wo]``; ``"bilinear"`` or ``"nearest"`` (round half
    to even), ``padding_mode`` ``"zeros"`` or ``"border"``."""
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sample padding_mode={padding_mode!r} unsupported "
            f"(zeros/border only)")
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"grid_sample mode={mode!r} unsupported")
    a, g = amp.amp_cast_inputs("grid_sample", [x, grid])
    n, _, h, w = a.shape

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1.0) * (size - 1) / 2.0
        return ((coord + 1.0) * size - 1.0) / 2.0

    gx, gy = unnorm(g[..., 0], w), unnorm(g[..., 1], h)
    rows = torch.arange(n, device=a.device)[:, None, None]

    def sample(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = a[rows, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            v = torch.where(inb[..., None], v, 0.0)
        return v

    if mode == "nearest":
        out = sample(torch.round(gx).long(), torch.round(gy).long())
    else:
        x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
        wx, wy = gx - x0, gy - y0
        out = (sample(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
               + sample(x0 + 1, y0) * (wx * (1 - wy))[..., None]
               + sample(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
               + sample(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift: of ``[N * T, C, H, W]``, the first ``C * ratio``
    channels move one segment back in time, the next as many one
    forward."""
    if data_format != "NCHW":
        raise NotImplementedError("temporal_shift: NCHW only")
    (x,) = amp.amp_cast_inputs("temporal_shift", [x])
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    fc = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fc], torch.zeros_like(v[:, :1, :fc])], dim=1)
    right = torch.cat([torch.zeros_like(v[:, :1, fc:2 * fc]),
                       v[:, :-1, fc:2 * fc]], dim=1)
    return torch.cat([left, right, v[:, :, 2 * fc:]], dim=2).reshape(
        nt, c, h, w)


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is below the length
    (``maxlen`` defaults to the longest)."""
    (lens,) = amp.amp_cast_inputs("sequence_mask", [x])
    m = int(lens.max()) if maxlen is None else int(maxlen)
    rng = torch.arange(m, device=lens.device)
    return (rng < lens[..., None]).to(dtypes.convert_dtype(dtype))


def gather_tree(ids, parents):
    """Beam search's backtrace: ``ids``, ``parents [max_time, batch,
    beam]`` -> each beam's full sequence."""
    i, p = amp.amp_cast_inputs("gather_tree", [ids, parents])
    beams = torch.arange(i.shape[2], device=i.device).expand(i.shape[1:])
    toks = []
    for t in range(i.shape[0] - 1, -1, -1):
        toks.append(i[t].gather(-1, beams))
        beams = p[t].gather(-1, beams)
    return torch.stack(toks[::-1])


# ---------------------------------------------------------------------------
# distances and losses
# ---------------------------------------------------------------------------

def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    a, b = amp.amp_cast_inputs("pairwise_distance", [x, y])
    return _norm(a - b + epsilon, p, keepdim=keepdim)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    x, y = amp.amp_cast_inputs("poisson_nll_loss", [input, label])
    if log_input:
        loss = torch.exp(x) - y * x
    else:
        loss = x - y * torch.log(x + epsilon)
    if full:
        stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    x, y = amp.amp_cast_inputs("soft_margin_loss", [input, label])
    z = -y * x
    return _reduce(torch.logaddexp(z, torch.zeros_like(z)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    x, y, *w = amp.amp_cast_inputs(
        "multi_label_soft_margin_loss",
        [input, label] + ([weight] if weight is not None else []))
    loss = -(y * F.logsigmoid(x) + (1 - y) * F.logsigmoid(-x))
    if w:
        loss = loss * w[0]
    return _reduce(loss.mean(dim=-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    x, y, *w = amp.amp_cast_inputs(
        "multi_margin_loss",
        [input, label] + ([weight] if weight is not None else []))
    c = x.shape[1]
    y = y.long()
    correct = x.gather(1, y[:, None])
    m = torch.clamp(margin - correct + x, min=0.0) ** p
    if w:
        m = m * w[0][y][:, None]
    hot = F.one_hot(y, c).to(x.dtype)
    return _reduce((m * (1 - hot)).sum(-1) / c, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is not None:
        dp = distance_function(input, positive)
        dn = distance_function(input, negative)
        if swap:
            dpn = distance_function(positive, negative)
            dn, dpn = amp.amp_cast_inputs("tm_swap", [dn, dpn])
            dn = torch.minimum(dn, dpn)
        dp, dn = amp.amp_cast_inputs("triplet_margin_distance", [dp, dn])
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)
    a, pos, neg = amp.amp_cast_inputs("triplet_margin_distance",
                                      [input, positive, negative])
    dp, dn = _norm(a - pos), _norm(a - neg)
    if swap:
        dn = torch.minimum(dn, _norm(pos - neg))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the complete binary tree of
    ``num_classes`` leaves (heap-numbered internal nodes ``1..K-1``, class
    ``c`` the leaf ``c + K``) or over a custom ``path_table`` /
    ``path_code``: the sum of ``-log sigmoid((1 - 2 code) (w_n . x +
    b_n))`` along the root-to-leaf path, ``[N, 1]``."""
    K = int(num_classes)
    depth = max(K - 1, 1).bit_length() + 1
    args = [input, label, weight] + [t for t in (bias,) if t is not None]
    if path_table is not None:
        args += [path_table, path_code]
    x, y, w, *rest = amp.amp_cast_inputs("hsigmoid_loss", args)
    it = iter(rest)
    b = next(it) if bias is not None else None
    yl = y.reshape(-1).long()
    if path_table is not None:
        nodes = next(it).long()
        codes = next(it).to(x.dtype)
        valid = nodes >= 0
        nodes = nodes.clamp_min(0)
    else:
        leaf = yl + K
        nbits = torch.floor(torch.log2(leaf.float())).long()
        shift = nbits[:, None] - 1 - torch.arange(depth, device=x.device)
        valid = shift >= 0
        sh = shift.clamp_min(0)
        codes = ((leaf[:, None] >> sh) & 1).to(x.dtype)
        nodes = torch.where(valid, leaf[:, None] >> (sh + 1), 1) - 1
    logits = torch.einsum("nd,npd->np", x, w[nodes])
    if b is not None:
        logits = logits + b.reshape(-1)[nodes]
    per_step = -F.logsigmoid((1.0 - 2.0 * codes) * logits)
    return torch.where(valid, per_step, 0.0).sum(dim=-1)[:, None]


__all__ = ["max_pool3d", "avg_pool3d", "adaptive_avg_pool3d",
           "max_pool2d_with_index", "max_pool1d_with_index", "max_unpool1d",
           "max_unpool2d", "max_unpool3d", "conv1d_transpose",
           "conv3d_transpose", "pixel_unshuffle", "fold", "affine_grid",
           "grid_sample", "temporal_shift", "sequence_mask", "gather_tree",
           "pairwise_distance", "poisson_nll_loss", "soft_margin_loss",
           "multi_label_soft_margin_loss", "multi_margin_loss",
           "triplet_margin_with_distance_loss", "hsigmoid_loss"]
