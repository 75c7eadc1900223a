"""Shape, layout, indexing and scatter ops (the port of
``paddle_tpu/ops/manipulation.py``).

Functional ops return new tensors (views where torch gives one); the
in-place variants (``reshape_``, ``squeeze_``, ``unsqueeze_``,
``fill_diagonal_``, ``fill_diagonal_tensor_``) change the tensor they are
given. Index outputs are int64 where the reference narrows them to int32
(ROADMAP C26)."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import dtype as dtypes
from ._util import as_tensor, promote

__all__ = [
    "reshape", "reshape_", "view", "flatten", "squeeze", "squeeze_",
    "unsqueeze", "unsqueeze_", "transpose", "moveaxis", "swapaxes", "concat",
    "stack", "hstack", "vstack", "split", "chunk", "unbind", "unstack",
    "tile", "expand", "expand_as", "broadcast_to", "broadcast_tensors",
    "flip", "rot90", "roll", "repeat_interleave", "pad", "cast", "numel",
    "as_real", "as_complex", "tolist", "tensordot", "take_along_axis",
    "put_along_axis", "index_select", "index_sample", "gather", "gather_nd",
    "scatter", "scatter_nd_add", "scatter_nd", "index_add", "index_put",
    "masked_select", "masked_fill", "masked_scatter", "where", "nonzero",
    "slice", "strided_slice", "shard_index", "unique", "unique_consecutive",
    "one_hot", "permute", "atleast_1d", "atleast_2d", "atleast_3d",
    "column_stack", "row_stack", "dstack", "hsplit", "vsplit", "dsplit",
    "tensor_split", "unflatten", "block_diag", "diagonal_scatter",
    "select_scatter", "slice_scatter", "index_fill", "unfold", "rank",
    "shape", "crop", "fliplr", "flipud", "index_copy", "view_as",
    "as_strided", "fill_diagonal_tensor", "fill_diagonal_tensor_",
    "fill_diagonal_"]


def _static_shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return tuple(int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                 for s in shape)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def reshape(x, shape, name=None):
    return torch.reshape(as_tensor(x), _static_shape(shape))


def _contiguous_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= builtins.max(s, 1)
    return tuple(reversed(strides))


def reshape_(x, shape, name=None):
    """Reshape ``x`` itself (a contiguous tensor) to ``shape``."""
    sh = reshape(x, shape).shape
    if not x.is_contiguous():
        raise ValueError("reshape_ needs a contiguous tensor")
    return x.as_strided_(sh, _contiguous_strides(sh))


def flatten(x, start_axis=0, stop_axis=-1):
    x = as_tensor(x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def _squeeze_dims(x, axis):
    if axis is None:
        return tuple(d for d in range(x.ndim) if x.shape[d] == 1)
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    return tuple(_int(a) % x.ndim for a in axis
                 if x.shape[_int(a) % x.ndim] == 1)


def squeeze(x, axis=None, name=None):
    """Drop the listed axes of size 1 (every one for None); an axis of
    another size stays."""
    x = as_tensor(x)
    return x.squeeze(_squeeze_dims(x, axis)) if x.ndim else x


def squeeze_(x, axis=None, name=None):
    for d in sorted(_squeeze_dims(x, axis), reverse=True):
        x.squeeze_(d)
    return x


def _unsqueeze_dims(x, axis):
    axis = axis if isinstance(axis, (list, tuple)) else [axis]
    nd = x.ndim + len(axis)
    return sorted(_int(a) % nd for a in axis)


def unsqueeze(x, axis, name=None):
    """New axes of size 1 at the listed positions of the result."""
    x = as_tensor(x)
    for d in _unsqueeze_dims(x, axis):
        x = x.unsqueeze(d)
    return x


def unsqueeze_(x, axis, name=None):
    for d in _unsqueeze_dims(x, axis):
        x.unsqueeze_(d)
    return x


def transpose(x, perm, name=None):
    return as_tensor(x).permute(*[int(p) for p in perm])


def moveaxis(x, source, destination):
    return torch.movedim(as_tensor(x), source, destination)


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(as_tensor(x), axis0, axis1)


def _tensors(x):
    return promote(*[as_tensor(t) for t in x])


def concat(x, axis=0, name=None):
    return torch.cat(_tensors(x), dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(_tensors(x), dim=axis)


def hstack(x):
    return torch.hstack(_tensors(x))


def vstack(x):
    return torch.vstack(_tensors(x))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts (which must divide the axis), or
    parts of the listed sizes, one of which may be -1 for the rest."""
    x = as_tensor(x)
    ax = _int(axis) % x.ndim
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if dim % n != 0:
            raise ValueError(
                f"split: axis dim {dim} is not divisible by num {n}")
        sizes = [dim // n] * n
    else:
        sizes = [_int(s) for s in num_or_sections]
        if builtins.any(s == -1 for s in sizes):
            rest = dim - builtins.sum(s for s in sizes if s != -1)
            sizes = [rest if s == -1 else s for s in sizes]
    return list(torch.split(x, sizes, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0):
    return list(torch.unbind(as_tensor(x), dim=axis))


def unstack(x, axis=0, num=None):
    return unbind(x, axis)


def tile(x, repeat_times):
    return torch.tile(as_tensor(x), tuple(_int(r) for r in repeat_times))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; -1 keeps the input's size there."""
    x = as_tensor(x)
    sh = _static_shape(shape)
    lead = len(sh) - x.ndim
    sh = tuple(x.shape[i - lead] if s == -1 else s for i, s in enumerate(sh))
    return x.expand(sh)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*[as_tensor(t) for t in inputs]))


def flip(x, axis):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    return torch.flip(as_tensor(x), ax)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(as_tensor(x), k, list(axes))


def roll(x, shifts, axis=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else shifts
    if axis is None:
        return torch.roll(as_tensor(x), sh)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.roll(as_tensor(x), sh, ax)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = as_tensor(x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a padded axis for the index-based modes."""
    idx = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return idx.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(idx, n)
    if n == 1:                                    # reflect
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - m, m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad list: one (before, after) pair per axis in axis order
    when it covers every axis, else pairs for the last axes from the last
    one backwards. ``"reflect"``, ``"replicate"`` and ``"circular"`` pad
    any axis, as ``jnp.pad``'s modes do."""
    x = as_tensor(x)
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.ndim
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        width = [(0, 0)] * nd
        for i in range(len(pad) // 2):
            width[nd - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return F.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def cast(x, dtype):
    return as_tensor(x).to(dtypes.convert_dtype(dtype))


def numel(x):
    x = as_tensor(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def as_real(x):
    x = as_tensor(x)
    return torch.stack([x.real, x.imag], dim=-1)


def as_complex(x):
    x = as_tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


def tolist(x):
    return as_tensor(x).tolist()


def tensordot(x, y, axes=2):
    return torch.tensordot(*promote(as_tensor(x), as_tensor(y)), dims=axes)


def take_along_axis(arr, indices, axis, broadcast=True):
    arr, idx = as_tensor(arr), as_tensor(indices).long()
    if broadcast:
        dst = list(arr.shape)
        dst[axis] = idx.shape[axis]
        idx = idx.expand(dst)
    return torch.take_along_dim(arr, idx, dim=axis)


_SCATTER_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod",
                   "multiply": "prod", "amax": "amax", "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    """Write ``values`` (broadcast to ``indices``) at ``indices`` along
    ``axis``: assigned, or reduced into the existing values with
    ``"add"``/``"mul"``/``"amax"``/``"amin"`` (the existing value always
    takes part, as in the reference)."""
    arr, idx = as_tensor(arr), as_tensor(indices).long()
    vals = as_tensor(values, arr).to(arr.dtype)
    if vals.shape != idx.shape:
        vals = vals.expand(idx.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, vals)
    if reduce not in _SCATTER_REDUCE:
        raise ValueError(f"unknown reduce {reduce}")
    return torch.scatter_reduce(arr, axis, idx, vals,
                                _SCATTER_REDUCE[reduce], include_self=True)


def _take(x, index, axis):
    """``jnp.take`` along ``axis`` with an index of any rank."""
    idx = index.long()
    out = torch.index_select(x, axis, idx.reshape(-1))
    ax = axis % x.ndim
    return out.reshape(*x.shape[:ax], *idx.shape, *x.shape[ax + 1:])


def index_select(x, index, axis=0):
    return _take(as_tensor(x), as_tensor(index), axis)


def index_sample(x, index):
    return torch.take_along_dim(as_tensor(x), as_tensor(index).long(), dim=1)


def gather(x, index, axis=0):
    x, index = as_tensor(x), as_tensor(index)
    return _take(x, index.reshape(-1) if index.ndim > 1 else index, axis)


def _nd_index(index):
    return tuple(as_tensor(index).long().movedim(-1, 0))


def gather_nd(x, index):
    return as_tensor(x)[_nd_index(index)]


def scatter(x, index, updates, overwrite=True):
    """Rows ``index`` of ``x`` replaced by ``updates``, or with
    ``overwrite=False`` zeroed and then summed into."""
    x, idx = as_tensor(x), (as_tensor(index).long(),)
    upd = as_tensor(updates, x).to(x.dtype)
    if overwrite:
        return x.index_put(idx, upd)
    return x.index_put(idx, torch.zeros_like(upd)).index_put(
        idx, upd, accumulate=True)


def scatter_nd_add(x, index, updates):
    x = as_tensor(x)
    return x.index_put(_nd_index(index), as_tensor(updates, x).to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape):
    updates = as_tensor(updates)
    z = torch.zeros(_static_shape(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


def index_add(x, index, axis, value):
    x = as_tensor(x)
    return torch.index_add(x, axis, as_tensor(index).long(),
                           as_tensor(value, x).to(x.dtype))


def index_put(x, indices, value, accumulate=False):
    x = as_tensor(x)
    idx = tuple(as_tensor(i, x) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    return x.index_put(idx, as_tensor(value, x).to(x.dtype),
                       accumulate=accumulate)


def masked_select(x, mask):
    x, mask = torch.broadcast_tensors(as_tensor(x), as_tensor(mask))
    return x[mask]


def masked_fill(x, mask, value):
    x = as_tensor(x)
    if isinstance(value, torch.Tensor):
        x, value = promote(x, value)
    return torch.where(as_tensor(mask, x), value, x)


def masked_scatter(x, mask, value):
    """``value``'s elements in order at the True positions of ``mask``
    (broadcast to ``x``)."""
    x = as_tensor(x)
    mask = as_tensor(mask, x).expand(x.shape)
    flat = as_tensor(value, x).reshape(-1).to(x.dtype)
    cnt = torch.cumsum(mask.reshape(-1).long(), 0) - 1
    gathered = flat[cnt.clamp(0, flat.shape[0] - 1)].reshape(x.shape)
    return torch.where(mask, gathered, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    c = as_tensor(condition)
    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        x, y = promote(x, y)
    return torch.where(c, x, y)


def nonzero(x, as_tuple=False):
    """The indices of the nonzero elements, int64: ``[n, ndim]``, or with
    ``as_tuple`` one ``[n, 1]`` tensor an axis."""
    nz = torch.nonzero(as_tensor(x))
    if as_tuple:
        return tuple(nz[:, d:d + 1] for d in range(nz.shape[1]))
    return nz


def slice(input, axes, starts, ends):
    idx = [builtins.slice(None)] * input.ndim
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(_int(st), _int(en))
    return input[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """Python slicing with strides; a negative stride reverses, as numpy's
    does (torch's slicing takes none)."""
    x = as_tensor(x)
    out = x
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        sl = builtins.slice(_int(st), _int(en), _int(sr))
        pos = np.arange(x.shape[ax])[sl]
        out = out.index_select(ax, torch.as_tensor(pos, device=x.device)) \
            if _int(sr) < 0 else out[(builtins.slice(None),) * ax + (sl,)]
    return out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = as_tensor(input)
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    in_shard = (a >= lo) & (a < lo + size)
    return torch.where(in_shard, a - lo, torch.full_like(a, ignore_value))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """The sorted unique values (of the flattened tensor for None), and on
    request the index of each one's first occurrence, the inverse and the
    counts, in ``jnp.unique``'s order."""
    x = as_tensor(x)
    # no gradient, as in the reference (torch's has none to give)
    vals, inverse, counts = torch.unique(x.detach(), sorted=True,
                                         return_inverse=True,
                                         return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        inv = inverse.reshape(-1) if axis is None else inverse
        n = x.numel() if axis is None else x.shape[axis]
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), n, dtype=torch.int64,
                           device=x.device)
        out.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Consecutive duplicates of the flattened tensor collapsed, with the
    flattened inverse and the counts on request."""
    x = as_tensor(x)
    if axis is not None:
        raise NotImplementedError("unique_consecutive over an axis")
    vals, inverse, counts = torch.unique_consecutive(
        x.detach().reshape(-1), return_inverse=True, return_counts=True)
    out = [vals]
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def one_hot(x, num_classes, name=None):
    """float32 rows; a class outside [0, num_classes) gives a row of
    zeros, as ``jax.nn.one_hot``."""
    x = as_tensor(x)
    return (x[..., None] == torch.arange(num_classes, device=x.device)).to(
        torch.float32)


def permute(x, *perm, name=None):
    if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
        perm = tuple(perm[0])
    return transpose(x, list(perm))


def _atleast(nd, fn):
    def go(*inputs, name=None):
        outs = [fn(as_tensor(t)) for t in inputs]
        return outs[0] if len(outs) == 1 else outs
    go.__name__ = go.__qualname__ = f"atleast_{nd}d"
    return go


atleast_1d = _atleast(1, torch.atleast_1d)
atleast_2d = _atleast(2, torch.atleast_2d)
atleast_3d = _atleast(3, torch.atleast_3d)


def column_stack(x, name=None):
    return torch.column_stack(_tensors(x))


def row_stack(x, name=None):
    return torch.vstack(_tensors(x))


def dstack(x, name=None):
    return torch.dstack(_tensors(x))


def hsplit(x, num_or_indices, name=None):
    return list(torch.hsplit(as_tensor(x), num_or_indices))


def vsplit(x, num_or_indices, name=None):
    return list(torch.vsplit(as_tensor(x), num_or_indices))


def dsplit(x, num_or_indices, name=None):
    return list(torch.dsplit(as_tensor(x), num_or_indices))


def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(torch.tensor_split(as_tensor(x), num_or_indices, dim=axis))


def unflatten(x, axis, shape, name=None):
    return torch.unflatten(as_tensor(x), axis, tuple(int(s) for s in shape))


def block_diag(inputs, name=None):
    return torch.block_diag(*[torch.atleast_2d(t)
                              for t in _tensors(inputs)])


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    x = as_tensor(x)
    return torch.diagonal_scatter(x, as_tensor(y, x).to(x.dtype), offset,
                                  axis1, axis2)


def select_scatter(x, values, axis, index):
    x = as_tensor(x)
    return torch.select_scatter(x, as_tensor(values, x).to(x.dtype), axis,
                                index)


def slice_scatter(x, value, axes, starts, ends, strides=None):
    x = as_tensor(x)
    strides = strides or [1] * len(axes)
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(int(st), int(en), int(sr))
    out = x.clone()
    out[tuple(idx)] = as_tensor(value, x).to(x.dtype)
    return out


def index_fill(x, index, axis, value):
    x = as_tensor(x)
    v = value.item() if isinstance(value, torch.Tensor) else value
    return torch.index_fill(x, axis % x.ndim, as_tensor(index, x).long(), v)


def unfold(x, axis, size, step):
    """Windows of ``size`` every ``step`` along ``axis``; the window is a
    new last axis."""
    return as_tensor(x).unfold(int(axis), int(size), int(step))


def rank(x):
    """The number of axes, a 0-dim int32 tensor."""
    x = as_tensor(x)
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)


def shape(x):
    """The shape, a 1-D int32 tensor."""
    x = as_tensor(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def crop(x, shape=None, offsets=None, name=None):
    """The region of ``shape`` at ``offsets`` (a -1 in ``shape`` keeps the
    rest of that axis)."""
    x = as_tensor(x)
    xs = list(x.shape)
    if shape is None:
        shape = xs
    if hasattr(shape, "tolist"):
        shape = shape.tolist()
    if offsets is None:
        offsets = [0] * len(xs)
    if hasattr(offsets, "tolist"):
        offsets = offsets.tolist()
    if len(shape) != len(xs) or len(offsets) != len(xs):
        raise ValueError(
            f"crop: shape/offsets rank {len(shape)}/{len(offsets)} must "
            f"equal input rank {len(xs)}")
    starts = [int(o) for o in offsets]
    sizes = [int(xs[i] - starts[i]) if int(s) == -1 else int(s)
             for i, s in enumerate(shape)]
    for i, (st, sz) in enumerate(zip(starts, sizes)):
        if st < 0 or sz < 0 or st + sz > xs[i]:
            raise ValueError(
                f"crop: dim {i} region [{st}, {st + sz}) out of bounds "
                f"for extent {xs[i]}")
    return x[tuple(builtins.slice(st, st + sz)
                   for st, sz in zip(starts, sizes))]


def fliplr(x):
    return torch.fliplr(as_tensor(x))


def flipud(x):
    return torch.flipud(as_tensor(x))


def index_copy(x, index, axis, value):
    x = as_tensor(x)
    return torch.index_copy(x, axis % x.ndim, as_tensor(index, x).long(),
                            as_tensor(value, x).to(x.dtype))


def view(x, shape_or_dtype, name=None):
    """A reshape (a list or tuple), or the bits reread as another dtype,
    the last axis rescaled by the ratio of the item sizes."""
    x = as_tensor(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(int(s) for s in shape_or_dtype))
    return x.view(dtypes.convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return view(x, list(other.shape))


def as_strided(x, shape, stride, offset=0, name=None):
    """A strided view over ``x``'s elements in row-major order."""
    flat = as_tensor(x).contiguous().view(-1)
    return torch.as_strided(flat, tuple(int(s) for s in shape),
                            tuple(int(s) for s in stride),
                            flat.storage_offset() + int(offset))


def _diag_index(a, offset, dim1, dim2):
    n = (builtins.min(a.shape[dim1], a.shape[dim2] - offset) if offset >= 0
         else builtins.min(a.shape[dim1] + offset, a.shape[dim2]))
    i = torch.arange(n, device=a.device) + builtins.max(-offset, 0)
    j = torch.arange(n, device=a.device) + builtins.max(offset, 0)
    return i, j


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written along the (dim1, dim2) diagonal of ``x`` (its last
    axis running along the diagonal)."""
    x = as_tensor(x)
    y = as_tensor(y, x).to(x.dtype)
    i, j = _diag_index(x, offset, dim1, dim2)
    moved = x.movedim((dim1, dim2), (0, 1)).clone()
    moved[i, j] = y.movedim(-1, 0) if y.ndim else y
    return moved.movedim((0, 1), (dim1, dim2))


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    out = fill_diagonal_tensor(x, y, offset=offset, dim1=dim1, dim2=dim2)
    return x.copy_(out)


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """Fill the (offset) diagonal of ``x`` in place; an n-d tensor (n > 2,
    all axes equal, offset 0) fills its (i, i, ..., i) diagonal; ``wrap``
    restarts a tall matrix's diagonal every ``cols + 1`` rows."""
    a = x
    if a.ndim > 2:
        if offset != 0:
            raise ValueError("fill_diagonal_: offset is only supported "
                             "for 2-D tensors")
        if len(set(a.shape)) != 1:
            raise ValueError("fill_diagonal_: ndim>2 needs all dims equal")
        i = torch.arange(a.shape[0], device=a.device)
        idx = (i,) * a.ndim
    elif a.ndim == 2 and wrap and a.shape[0] > a.shape[1]:
        rows = torch.arange(a.shape[0], device=a.device)
        cols = torch.remainder(rows + offset, a.shape[1] + 1)
        hit = cols < a.shape[1]
        idx = (rows[hit], cols[hit])
    else:
        n = builtins.min(a.shape[-2] - builtins.max(-offset, 0),
                         a.shape[-1] - builtins.max(offset, 0))
        i = torch.arange(n, device=a.device) + builtins.max(-offset, 0)
        j = torch.arange(n, device=a.device) + builtins.max(offset, 0)
        idx = (Ellipsis, i, j)
    x[idx] = value
    return x
