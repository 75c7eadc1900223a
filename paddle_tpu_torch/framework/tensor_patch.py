"""Paddle's Tensor members on ``torch.Tensor`` (port of
``paddle_tpu/framework/tensor_patch.py`` and the Paddle-only members of
the reference's ``Tensor`` class, ``core.py:114-411``).

``paddle.Tensor`` is ``torch.Tensor``. :func:`install` runs once, at
``import paddle_tpu_torch``, and follows the reference's own rule
(``tensor_patch.py:131-134``): a name is set only where the class lacks
it. So nothing of torch is overridden: a name torch already has keeps
torch's meaning (:data:`KEPT`; ROADMAP C34 lists those whose Paddle
meaning differs, :data:`DIFFERS`). The methods are the port's ops
(``paddle_tpu_torch.ops``) with the tensor as first argument, and the
in-place variants write the op's result back into the tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes

#: the reference's method list (``tensor_patch.py:97-130``)
METHODS = """
    add subtract multiply divide floor_divide mod remainder pow maximum minimum
    fmax fmin atan2 lerp logaddexp equal not_equal greater_than greater_equal
    less_than less_equal logical_and logical_or logical_xor logical_not
    bitwise_and bitwise_or bitwise_xor bitwise_not
    exp expm1 log log2 log10 log1p sqrt rsqrt square abs sign neg reciprocal
    floor ceil round trunc frac sin cos tan asin acos atan sinh cosh tanh
    asinh acosh atanh erf erfinv sigmoid digamma lgamma clip scale stanh
    isnan isinf isfinite isclose allclose equal_all
    sum mean prod max min amax amin logsumexp std var median nanmedian
    quantile nansum nanmean count_nonzero cumsum cumprod cummax cummin
    logcumsumexp matmul mm bmm dot inner outer addmm kron cross trace t
    argmax argmin argsort sort topk kthvalue mode searchsorted bucketize
    reshape flatten squeeze unsqueeze transpose moveaxis swapaxes
    concat stack split chunk unbind unstack tile expand expand_as
    broadcast_to flip rot90 roll repeat_interleave pad cast
    take_along_axis put_along_axis index_select index_sample gather gather_nd
    scatter scatter_nd_add index_add index_put masked_select masked_fill
    tril triu
    masked_scatter where nonzero unique unique_consecutive
    norm dist histogram bincount increment lcm gcd heaviside hypot
    nan_to_num multiplex divide_no_nan tensordot
    all any take permute diff mv
    reshape_ squeeze_ unsqueeze_
    ldexp frexp sinc signbit isneginf isposinf isreal i0 i0e i1 i1e
    polygamma gammainc gammaincc multigammaln nanquantile renorm
    bitwise_left_shift bitwise_right_shift combinations clip_by_norm
    unflatten diagonal_scatter select_scatter slice_scatter index_fill
    tensor_split hsplit vsplit dsplit vander atleast_1d atleast_2d
    atleast_3d
    sgn cdist unfold trapezoid cumulative_trapezoid rank
    float_power vdot nanargmax nanargmin positive isin fliplr
    flipud index_copy view view_as
""".split()

#: the reference's in-place variants of out-of-place ops (``:137-143``)
INPLACE = [n + "_" for n in """add subtract multiply divide scale clip exp
    sqrt rsqrt reciprocal floor ceil round abs sin cos tanh sigmoid neg
    erfinv pow mod remainder lerp masked_fill index_put put_along_axis
    index_add scatter tril triu""".split()]

#: the reference's other in-place fills (``:145-180``) and the members of
#: its ``Tensor`` class (``core.py:114-411``); its ``__dunder__``
#: operators all exist on ``torch.Tensor`` with the same meaning
MEMBERS = """
    zero_ fill_ fill_diagonal_ uniform_ cauchy_ geometric_ log_normal_
    normal_ bernoulli_ exponential_ floor_divide_ apply_ apply
    stop_gradient grad name persistable process_mesh placements shape dtype
    ndim dim size place is_leaf T numel numpy item tolist backward
    retain_grads register_hook clear_grad clear_gradient detach detach_
    clone set_value copy_ astype cast cpu cuda element_size nbytes
    data_ptr is_sparse coalesce to pin_memory contiguous is_contiguous
    gradient
""".split()

#: names torch already has whose Paddle meaning differs (ROADMAP C34);
#: torch's meaning is kept
DIFFERS = {
    "shape": "a list in Paddle, a torch.Size in torch",
    "size": "numel (a property) in Paddle, the shape (a method) in torch",
    "dim": "an int property in Paddle, a method in torch",
    "name": "an auto-generated string in Paddle, None in torch",
    "numpy": "Paddle's reads any tensor; torch's needs a detached CPU one "
             "(numpy(force=True) reads any)",
    "to": "Paddle's takes dtype and device strings ('float32', 'gpu')",
    "reshape": "0 in Paddle's shape keeps that dimension",
    "transpose": "a permutation in Paddle, two dims in torch",
    "split": "Paddle's num_or_sections counts the sections; torch's "
             "split_size is each section's size",
    "max": "with an axis, Paddle's returns the values, torch's (values, "
           "indices)",
    "min": "as max",
    "sort": "Paddle's returns the values, torch's (values, indices)",
    "median": "with an axis, Paddle's returns the values, torch's "
              "(values, indices)",
    "nanmedian": "as median",
    "cumsum": "Paddle's axis=None flattens; torch's needs a dim",
    "cumprod": "Paddle's dim=None flattens; torch's needs a dim",
    "gather": "gather(index, axis) picks rows in Paddle; torch's "
              "gather(dim, index) picks elements",
    "scatter": "scatter(index, updates, overwrite) writes rows in Paddle; "
               "torch's scatter(dim, index, src) writes elements",
    "scatter_": "as scatter",
    "index_select": "(index, axis) in Paddle, (dim, index) in torch",
    "index_add": "(index, axis, value) in Paddle, (dim, index, source) in "
                 "torch",
    "index_add_": "as index_add",
    "index_fill": "(index, axis, value) in Paddle, (dim, index, value) in "
                  "torch",
    "index_copy": "(index, value, axis) in Paddle, (dim, index, source) "
                  "in torch",
    "where": "Paddle's binds the tensor as the condition, torch's as the "
             "value where the condition holds",
    "unique": "Paddle's positional flags are return_index, "
              "return_inverse, return_counts; torch's sorted, "
              "return_inverse, return_counts",
    "equal": "elementwise (a tensor) in Paddle, one bool in torch",
    "allclose": "a bool tensor in Paddle, a bool in torch",
    "trace": "Paddle's takes offset and axes",
    "histogram": "(bins, min, max) giving counts in Paddle; torch's gives "
                 "(hist, bin_edges) over a range",
    "slice_scatter": "(value, axes, starts, ends, strides) in Paddle, "
                     "(src, dim, start, end, step) in torch",
    "fill_diagonal_": "Paddle's takes an offset",
    "apply_": "torch's runs on CPU tensors only",
    "uniform_": "Paddle's takes a seed",
    "geometric_": "torch's counts trials (support 1, 2, ...; mean 1/p); "
                  "Paddle's draws distribution.Geometric, which counts "
                  "failures (support 0, 1, ...; mean (1-p)/p)",
}

#: names this module set on ``torch.Tensor``, and names it left to torch
INSTALLED, KEPT = [], []


def _ops():
    from .. import ops
    return ops


def _op(name):
    ops = _ops()
    fn = getattr(ops, name, None) or getattr(ops.linalg, name, None)
    if fn is None:
        raise AttributeError(f"no port op {name!r} for Tensor.{name}")
    return fn


def _swap(fn):
    """The in-place variant of op ``fn``: its result written back into
    the tensor (recorded by autograd as a copy)."""

    def inplace(self, *args, **kwargs):
        return self.copy_(fn(self, *args, **kwargs))

    inplace.__name__ = fn.__name__ + "_"
    inplace.__doc__ = f"In-place ``{fn.__name__}``."
    return inplace


def _get_stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, value):
    """``stop_gradient = True`` detaches a tensor that autograd produced
    (in place) and clears ``requires_grad`` on a leaf."""
    if value and not self.is_leaf:
        self.detach_()
    else:
        self.requires_grad_(not value)


def _astype(self, dtype):
    return self.to(dtypes.convert_dtype(dtype))


def _clear_grad(self):
    self.grad = None


@torch.no_grad()
def _set_value(self, value):
    """Copy ``value`` (a tensor or an array of the same shape) into the
    tensor, in its dtype."""
    src = torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value)
    if tuple(src.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch {tuple(src.shape)} vs "
                         f"{tuple(self.shape)}")
    self.copy_(src.to(device=self.device, dtype=self.dtype))
    return self


def _place(self):
    from .core import place_of
    return place_of(self.device)


def _gradient(self):
    """The gradient as a numpy array, or None."""
    return None if self.grad is None else self.grad.numpy(force=True)


def _apply(self, func):
    """``func`` on every element (a host-side loop, as the reference's):
    a new tensor on the same device."""
    arr = self.numpy(force=True)
    out = np.vectorize(func)(arr).astype(arr.dtype)
    return torch.from_numpy(out).to(self.device).requires_grad_(
        self.requires_grad and self.is_floating_point())


def _members():
    return {
        "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
        "astype": _astype,
        "cast": _astype,
        "clear_grad": _clear_grad,
        "clear_gradient": _clear_grad,
        "set_value": _set_value,
        "place": property(_place),
        "gradient": _gradient,
        "retain_grads": lambda self: self.retain_grad(),
        "apply": _apply,
        # the reference's per-tensor attributes, with its defaults
        "persistable": False,
        "process_mesh": None,
        "placements": None,
    }


def install():
    """Set every reference name ``torch.Tensor`` lacks; record the rest in
    :data:`KEPT`. Runs once."""
    if INSTALLED or KEPT:
        return
    members = _members()
    T = torch.Tensor
    for name in dict.fromkeys(METHODS + INPLACE + MEMBERS):
        if hasattr(T, name):
            KEPT.append(name)
            continue
        if name in members:
            value = members[name]
        elif name.endswith("_") and name in INPLACE:
            value = _swap(_op(name[:-1]))
        else:
            value = _op(name)
        setattr(T, name, value)
        INSTALLED.append(name)


__all__ = ["install", "INSTALLED", "KEPT", "DIFFERS", "METHODS", "INPLACE",
           "MEMBERS"]
