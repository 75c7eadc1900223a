"""``paddle.sparse`` (port of ``paddle_tpu/sparse/__init__.py``): COO and
CSR tensors and their ops on torch's sparse layouts.

``SparseCooTensor`` keeps ``indices`` ``[ndim, nnz]``, ``values`` and the
shape, duplicates included until ``coalesce``; ``SparseCsrTensor`` keeps
``crows``, ``cols`` and ``values``. Each builds the torch sparse tensor it
stands for on demand (``_m``), so the values stay the tensors the caller
gave, differentiable through the pattern-keeping ops. ``matmul`` runs
``torch.sparse.mm`` (cuSPARSE SpMM on the card) on COO or CSR as given,
differentiable in the dense operand. Results hold only real entries: the
reference's BCOO results carry padding up to a fixed ``nse`` (an index
equal to the dimension's size, value 0), which the port does not store
(ROADMAP C49). Where the reference builds a result from a dense array
(``multiply`` by a dense tensor, ``sum`` over an axis, ``slice``, the
convolutions), entries that are exactly zero are dropped, as there; where
it keeps coordinates (``add``, ``coalesce``, sparse times sparse), they
stay. COO indices are int64 (C26), CSR's ``crows`` and ``cols`` int32.

The constructors put their result on the ops layer's current device
(``set_device``), or on the values' device when they are a tensor. The
convolutions densify the grid as the reference does: their memory grows
with the grid, not with the voxels.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
from torch.nn import functional as F

from ..framework import dtype as dtypes
from ..framework.core import current_device, device_of, to_tensor
from ..ops._util import as_tensor

__all__ = [
    "sparse_coo_tensor", "sparse_csr_tensor", "SparseCooTensor",
    "SparseCsrTensor", "add", "multiply", "matmul", "masked_matmul", "relu",
    "is_sparse", "nn",
    "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
    "sqrt", "square", "abs", "pow", "neg", "expm1", "log1p", "cast",
    "rad2deg", "deg2rad", "isnan",
    "subtract", "divide", "sum", "transpose", "reshape", "coalesce",
    "is_same_shape", "mask_as", "slice", "mv", "addmm",
]


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


class SparseCooTensor:
    """COO sparse tensor: ``indices`` ``[ndim, nnz]``, ``values`` ``[nnz,
    ...]`` (trailing dense dimensions allowed), ``shape``."""

    def __init__(self, indices, values, shape, coalesced=False):
        self._indices = indices
        self._values = values
        self._shape = tuple(int(s) for s in shape)
        self._coalesced = coalesced

    @property
    def _m(self):
        """The torch sparse COO tensor (no copy)."""
        return torch.sparse_coo_tensor(
            self._indices.long(), self._values, self._shape,
            is_coalesced=self._coalesced or None, check_invariants=False)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def nnz(self):
        return int(self._values.shape[0])

    def indices(self):
        return self._indices

    def values(self):
        return self._values

    def to_dense(self):
        return self._m.to_dense()

    def to_sparse_csr(self):
        c = self.coalesce()
        rows, cols = c._indices[0], c._indices[1]
        crows = torch._convert_indices_from_coo_to_csr(
            rows, self._shape[0], out_int32=True)
        return SparseCsrTensor(crows, cols.int(), c._values, self._shape)

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def coalesce(self):
        if self._coalesced:
            return self
        m = self._m.coalesce()
        return SparseCooTensor(m.indices().to(self._indices.dtype),
                               m.values(), self._shape, coalesced=True)

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={_dtype_name(self.dtype)})")


class SparseCsrTensor:
    """CSR sparse matrix: ``crows`` ``[rows + 1]``, ``cols`` and
    ``values`` ``[nnz]``."""

    def __init__(self, crows, cols, values, shape):
        self._crows = crows
        self._cols = cols
        self._values = values
        self._shape = tuple(int(s) for s in shape)

    @property
    def _m(self):
        """The torch sparse CSR tensor (no copy)."""
        return torch.sparse_csr_tensor(self._crows, self._cols, self._values,
                                       self._shape, check_invariants=False)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def nnz(self):
        return int(self._values.shape[0])

    def crows(self):
        return self._crows

    def cols(self):
        return self._cols

    def values(self):
        return self._values

    def to_dense(self):
        return self._m.to_dense()

    def to_sparse_coo(self, sparse_dim=None):
        rows = torch.repeat_interleave(
            torch.arange(self._shape[0], device=self._crows.device),
            self._crows.diff(), output_size=self._cols.numel())
        idx = torch.stack([rows, self._cols.long()])
        return SparseCooTensor(idx, self._values, self._shape,
                               coalesced=True)

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={_dtype_name(self.dtype)})")


def _place_values(values, dtype, place):
    """``values`` as a tensor: on ``place`` when given, else a tensor's own
    device, else the current device (Python floats in the default dtype,
    as ``to_tensor`` gives); cast to ``dtype``."""
    if isinstance(values, torch.Tensor):
        vals = values if place is None else values.to(device_of(place))
    else:
        vals = to_tensor(values, place=place)
    if dtype is not None:
        vals = vals.to(dtypes.convert_dtype(dtype))
    return vals


def _index_tensor(x, device, dtype):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    vals = _place_values(values, dtype, place)
    idx = _index_tensor(indices, vals.device, torch.long)
    if shape is None:
        shape = [int(m) + 1 for m in idx.max(dim=1).values.tolist()]
    return SparseCooTensor(idx, vals, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, **kw):
    vals = _place_values(values, dtype, None)
    return SparseCsrTensor(_index_tensor(crows, vals.device, torch.int32),
                           _index_tensor(cols, vals.device, torch.int32),
                           vals, shape)


def is_sparse(x):
    return isinstance(x, (SparseCooTensor, SparseCsrTensor))


def _coo(x):
    if isinstance(x, SparseCsrTensor):
        return x.to_sparse_coo()
    return x


def _like(x, out):
    """``out`` (COO) as CSR where ``x`` is CSR and ``out`` a matrix."""
    if isinstance(x, SparseCsrTensor) and len(out._shape) == 2:
        return out.to_sparse_csr()
    return out


def _with_values(x, vals):
    """``x``'s pattern (COO or CSR, as given) over new values."""
    if isinstance(x, SparseCsrTensor):
        return SparseCsrTensor(x._crows, x._cols, vals, x._shape)
    return SparseCooTensor(x._indices, vals, x._shape, x._coalesced)


def _linear(idx, shape):
    """Row-major linear positions of ``idx`` ``[ndim, nnz]``."""
    key = torch.zeros_like(idx[0], dtype=torch.long)
    for d, n in enumerate(shape):
        key = key * n + idx[d].long()
    return key


def _nonzero_entries(dense):
    """The COO of a dense array's nonzero elements in row-major order (the
    entries ``bcoo_fromdense`` keeps before its padding)."""
    mask = dense != 0
    idx = mask.nonzero().T.contiguous()
    return SparseCooTensor(idx, dense[mask], dense.shape, coalesced=True)


def _drop_zeros(c):
    keep = c._values != 0
    return SparseCooTensor(c._indices[:, keep], c._values[keep], c._shape,
                           coalesced=c._coalesced)


def _at(dense, idx):
    return dense[tuple(idx.long())]


# -- ops --------------------------------------------------------------------

def add(x, y):
    if is_sparse(x) and is_sparse(y):
        xc, yc = _coo(x), _coo(y)
        both = SparseCooTensor(torch.cat([xc._indices, yc._indices], 1),
                               torch.cat([xc._values, yc._values]),
                               xc._shape)
        return both.coalesce()
    if is_sparse(x):
        return x.to_dense() + as_tensor(y, x._values)
    return as_tensor(x, y._values) + y.to_dense()


def multiply(x, y):
    if is_sparse(x) and not is_sparse(y):
        c = _coo(x).coalesce()
        d = as_tensor(y, c._values).broadcast_to(c._shape)
        vals = c._values * _at(d, c._indices)
        return _drop_zeros(SparseCooTensor(c._indices, vals, c._shape,
                                           coalesced=True))
    if is_sparse(x) and is_sparse(y):
        # each of x's entries, in x's stored order, that y also holds
        xc, yc = _coo(x), _coo(y).coalesce()
        xk, yk = _linear(xc._indices, xc._shape), _linear(yc._indices,
                                                          yc._shape)
        pos = torch.searchsorted(yk, xk).clamp_max(max(yk.numel() - 1, 0))
        hit = (yk[pos] == xk) if yk.numel() else torch.zeros_like(
            xk, dtype=torch.bool)
        return SparseCooTensor(xc._indices[:, hit],
                               xc._values[hit] * yc._values[pos[hit]],
                               xc._shape, xc._coalesced)
    return multiply(y, x)


def matmul(x, y):
    """Sparse @ dense or dense @ sparse -> dense, differentiable in the
    dense operand."""
    if is_sparse(x):
        d = as_tensor(y, x._values)
        if d.ndim == 1:
            return torch.sparse.mm(x._m, d[:, None])[:, 0]
        return torch.sparse.mm(x._m, d)
    if is_sparse(y):
        d = as_tensor(x, y._values)
        yt = transpose(_coo(y), [1, 0])
        flat = d.reshape(-1, d.shape[-1])
        out = torch.sparse.mm(yt._m, flat.T).T
        return out.reshape(tuple(d.shape[:-1]) + (y._shape[1],))
    from ..ops import math as pmath
    return pmath.matmul(x, y)


def masked_matmul(x, y, mask):
    """``x @ y`` sampled at ``mask``'s entries (SDDMM), as COO."""
    x = as_tensor(x)
    y = as_tensor(y, x)
    mc = _coo(mask)
    rows, cols = mc._indices[0], mc._indices[1]
    vals = (x.index_select(0, rows) * y.index_select(1, cols).T).sum(-1)
    return SparseCooTensor(mc._indices, vals, mc._shape, mc._coalesced)


def relu(x):
    c = _coo(x)
    return SparseCooTensor(c._indices, torch.relu(c._values), c._shape,
                           c._coalesced)


# -- elementwise value ops: pattern-keeping maps over the stored values ------

def _unary(x, vfn):
    return _with_values(x, vfn(x._values))


def sin(x, name=None):
    return _unary(x, torch.sin)


def tan(x, name=None):
    return _unary(x, torch.tan)


def asin(x, name=None):
    return _unary(x, torch.asin)


def atan(x, name=None):
    return _unary(x, torch.atan)


def sinh(x, name=None):
    return _unary(x, torch.sinh)


def tanh(x, name=None):
    return _unary(x, torch.tanh)


def asinh(x, name=None):
    return _unary(x, torch.asinh)


def atanh(x, name=None):
    return _unary(x, torch.atanh)


def sqrt(x, name=None):
    return _unary(x, torch.sqrt)


def square(x, name=None):
    return _unary(x, torch.square)


def abs(x, name=None):
    return _unary(x, torch.abs)


def pow(x, factor, name=None):
    return _unary(x, lambda v: v ** factor)


def neg(x, name=None):
    return _unary(x, torch.neg)


def expm1(x, name=None):
    return _unary(x, torch.expm1)


def log1p(x, name=None):
    return _unary(x, torch.log1p)


def rad2deg(x, name=None):
    return _unary(x, torch.rad2deg)


def deg2rad(x, name=None):
    return _unary(x, torch.deg2rad)


def isnan(x, name=None):
    return _unary(x, torch.isnan)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    vals = x._values if value_dtype is None else \
        x._values.to(dtypes.convert_dtype(value_dtype))
    if index_dtype is None:
        return _with_values(x, vals)
    it = dtypes.convert_dtype(index_dtype)
    if isinstance(x, SparseCsrTensor):
        return SparseCsrTensor(x._crows.to(it), x._cols.to(it), vals,
                               x._shape)
    return SparseCooTensor(x._indices.to(it), vals, x._shape, x._coalesced)


# -- binary / reductions / structure -----------------------------------------

def subtract(x, y, name=None):
    if is_sparse(y):
        return add(x, neg(y))
    return x.to_dense() - as_tensor(y, x._values)


def divide(x, y, name=None):
    """Elementwise divide. Sparse / dense divides the stored values by the
    dense entries at their coordinates; sparse / sparse needs the same
    (coalesced) pattern on both sides."""
    c = _coo(x).coalesce()
    if is_sparse(y):
        yc = _coo(y).coalesce()
        if c._indices.shape != yc._indices.shape or bool(
                (c._indices.long() != yc._indices.long()).any()):
            raise ValueError("sparse.divide needs identical sparsity "
                             "patterns (coalesce first)")
        vals = c._values / yc._values
    else:
        vals = c._values / _at(as_tensor(y, c._values), c._indices)
    return _like(x, SparseCooTensor(c._indices, vals, c._shape,
                                    coalesced=True))


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """A dense scalar for ``axis=None``, else a sparse tensor with the axis
    (or axes) reduced; entries that sum to exactly zero are dropped."""
    c = _coo(x)
    vals = c._values if dtype is None else \
        c._values.to(dtypes.convert_dtype(dtype))
    if axis is None:
        out = vals.sum()
        return out[None] if keepdim else out
    nd = len(c._shape)
    axes = {int(a) % nd for a in (axis if isinstance(axis, (list, tuple))
                                  else [axis])}
    keep_dims = [d for d in range(nd) if d not in axes]
    if keepdim:
        idx = torch.stack([c._indices[d] if d not in axes
                           else torch.zeros_like(c._indices[d])
                           for d in range(nd)])
        shape = [1 if d in axes else c._shape[d] for d in range(nd)]
    else:
        idx = c._indices[keep_dims] if keep_dims else \
            c._indices.new_zeros((0, c._indices.shape[1]))
        shape = [c._shape[d] for d in keep_dims]
    if not shape:
        return vals.sum()
    out = _drop_zeros(SparseCooTensor(idx, vals, shape).coalesce())
    return _like(x, out)


def transpose(x, perm, name=None):
    c = _coo(x)
    perm = [int(p) for p in perm]
    out = SparseCooTensor(c._indices[perm], c._values,
                          [c._shape[p] for p in perm])
    return _like(x, out)


def reshape(x, shape, name=None):
    c = _coo(x)
    shape = [int(s) for s in shape]
    total = int(np.prod(c._shape))
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape = [total // known if s == -1 else s for s in shape]
    key = _linear(c._indices, c._shape)
    rows = []
    for n in reversed(shape):
        rows.append(key % n)
        key = key // n
    idx = torch.stack(rows[::-1]).to(c._indices.dtype)
    return _like(x, SparseCooTensor(idx, c._values, shape, c._coalesced))


def coalesce(x, name=None):
    return _coo(x).coalesce()


def is_same_shape(x, y, name=None):
    sx = x.shape if is_sparse(x) else list(as_tensor(x).shape)
    sy = y.shape if is_sparse(y) else list(as_tensor(y).shape)
    return list(sx) == list(sy)


def mask_as(x, mask, name=None):
    """Dense ``x`` sampled at ``mask``'s entries, in ``mask``'s format."""
    xa = as_tensor(x, mask._values)
    if isinstance(mask, SparseCsrTensor):
        vals = _at(xa, mask.to_sparse_coo()._indices)
    else:
        vals = _at(xa, mask._indices)
    return _with_values(mask, vals)


def slice(x, axes, starts, ends, name=None):
    """The entries of ``x`` inside ``[starts, ends)`` along ``axes`` (Python
    slicing: negative bounds count from the end, bounds clip), shifted to
    the slice's origin; zero entries dropped."""
    c = _coo(x).coalesce()
    shape = list(c._shape)
    keep = torch.ones(c.nnz, dtype=torch.bool, device=c._values.device)
    idx = c._indices.clone()
    for ax, st, en in zip(axes, starts, ends):
        ax = int(ax)
        lo, hi, _ = builtins.slice(int(st), int(en)).indices(shape[ax])
        hi = max(hi, lo)
        keep &= (idx[ax] >= lo) & (idx[ax] < hi)
        idx[ax] -= lo
        shape[ax] = hi - lo
    out = SparseCooTensor(idx[:, keep], c._values[keep], shape,
                          coalesced=True)
    return _like(x, _drop_zeros(out))


def mv(x, vec, name=None):
    """Sparse matrix @ dense vector -> dense vector."""
    return matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """``beta input + alpha (x @ y)`` with a sparse ``x`` (dense result)."""
    prod = matmul(x, y)
    base = input.to_dense() if is_sparse(input) else as_tensor(input, prod)
    return beta * base + alpha * prod


def _sparse_attention_impl(query, key, value, sparse_mask):
    """``paddle.sparse.nn.functional.attention``: softmax attention over
    ``sparse_mask``'s nonzero pattern (``[b * h, s, s]`` or ``[b, h, s,
    s]``), as the reference computes it: dense ``q k^T / sqrt(d)``, the
    entries outside the pattern set to -1e30, softmax, then ``@ v``."""
    q = as_tensor(query)
    k = as_tensor(key, q)
    v = as_tensor(value, q)
    b, h, s, d = q.shape
    lg = torch.matmul(q, k.transpose(-1, -2)) / (d ** 0.5)
    if is_sparse(sparse_mask):
        keep = sparse_mask.to_dense().reshape(b, h, s, s) != 0
        lg = lg.masked_fill(~keep, -1e30)
    return torch.matmul(torch.softmax(lg, dim=-1), v)


class _SparseConvBase(torch.nn.Module):
    """The sparse 3-D convolutions over a ``SparseCooTensor`` ``[N, D, H,
    W, C]``: the reference's dense convolution of the scattered voxels
    (``F.conv3d``, cuDNN on the card), in the weight's dtype (fp32 as
    created, as the reference computes). The weight is torch's
    ``[out, in, kd, kh, kw]`` (the reference's is ``[kd, kh, kw, in,
    out]``; ``convert.load_jax_state`` maps it), drawn on the current
    device from the reference's XavierUniform limit for its shape. The
    result holds the output's nonzero elements in row-major order; the
    submanifold variant keeps only the input's active voxels."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, subm=False):
        super().__init__()
        from ..nn.initializer import Uniform, XavierUniform
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 3
        self.kernel_size = tuple(int(k) for k in ks)
        self.stride = tuple(stride) if isinstance(stride, (list, tuple)) \
            else (stride,) * 3
        self.padding = tuple(padding) if isinstance(padding, (list, tuple)) \
            else (padding,) * 3
        self.subm = subm
        lim = XavierUniform().limit(self.kernel_size
                                    + (in_channels, out_channels))
        self.weight = torch.nn.Parameter(Uniform(-lim, lim)(
            (out_channels, in_channels) + self.kernel_size, "float32",
            current_device()))

    def forward(self, x):
        dense = _coo(x).to_dense().to(self.weight.dtype)
        out = F.conv3d(dense.permute(0, 4, 1, 2, 3), self.weight,
                       stride=self.stride, padding=self.padding)
        out = out.permute(0, 2, 3, 4, 1)
        if self.subm:
            active = dense.abs().sum(-1, keepdim=True) != 0
            out = torch.where(active, out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
        return _nonzero_entries(out)


class nn:
    """``paddle.sparse.nn``: the sparse layers and functions."""

    class ReLU(torch.nn.Module):
        def forward(self, x):
            return relu(x)

    class Conv3D(_SparseConvBase):
        """Sparse 3-D convolution over a ``SparseCooTensor`` ``[N, D, H, W,
        C]``."""

        def __init__(self, in_channels, out_channels, kernel_size,
                     stride=1, padding=0, **kw):
            super().__init__(in_channels, out_channels, kernel_size,
                             stride, padding, subm=False)

    class SubmConv3D(_SparseConvBase):
        """Submanifold sparse convolution: the output's active voxels are
        the input's."""

        def __init__(self, in_channels, out_channels, kernel_size,
                     stride=1, padding=0, **kw):
            super().__init__(in_channels, out_channels, kernel_size,
                             stride, padding, subm=True)

    class functional:
        attention = staticmethod(_sparse_attention_impl)
        relu = staticmethod(relu)


def softmax(x, axis=-1, name=None):
    """Softmax over the stored entries of each row (the last axis); the
    pattern is kept. Duplicate coordinates are summed first, each keeping
    its coordinate's result, as the reference's dense route gives."""
    c = _coo(x)
    nd = len(c._shape)
    if axis not in (-1, nd - 1):
        raise NotImplementedError("sparse.softmax supports the last axis")
    key = _linear(c._indices, c._shape)
    uniq, inv = torch.unique(key, return_inverse=True)
    summed = c._values.new_zeros(uniq.shape[0]).index_add(0, inv, c._values)
    row = torch.div(uniq, c._shape[-1], rounding_mode="floor")
    _, rid = torch.unique_consecutive(row, return_inverse=True)
    n_rows = int(rid.max()) + 1 if rid.numel() else 0
    top = summed.new_zeros(n_rows).scatter_reduce(
        0, rid, summed, "amax", include_self=False)
    e = torch.exp(summed - top[rid])
    sm = e / e.new_zeros(n_rows).index_add(0, rid, e)[rid]
    return _with_values(x, sm[inv])

