"""AMP debugging (port of ``paddle_tpu/amp/debugging.py``): the tensor
checker, ``check_numerics`` and the operator statistics.

The reference's checker scans every tape op's output for NaN/Inf while
``FLAGS_check_nan_inf`` is on (``enable_tensor_checker``). The port has
no tape and no flags: :func:`enable_tensor_checker` enters a PyTorch
dispatch mode on the calling thread that scans every ATen op's
floating-point outputs, raising ``FloatingPointError`` that names the
op, until :func:`disable_tensor_checker`. Like the reference's, it sees
the forward's ops on the thread that runs them (the backward runs in
autograd's own threads), and each scan waits for the device.
"""
from __future__ import annotations

import contextlib
import enum
from collections import Counter

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from . import _recorders


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Scan one tensor; raise ``FloatingPointError`` naming the op and
    the variable, with the NaN and Inf counts, if any element is not
    finite. Returns the tensor."""
    if tensor.is_floating_point() and not bool(torch.isfinite(tensor).all()):
        n_nan = int(torch.isnan(tensor).sum())
        n_inf = int(torch.isinf(tensor).sum())
        raise FloatingPointError(
            f"check_numerics: op={op_type or '?'} var={var_name or '?'} "
            f"has {n_nan} NaN / {n_inf} Inf values")
    return tensor


class _NanInfChecker(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                check_numerics(t, op_type=func.overloadpacket.__name__,
                               var_name="output")
        return out


_checkers = []


def enable_tensor_checker(checker_config=None):
    """Scan every op's outputs on this thread until
    :func:`disable_tensor_checker`."""
    if checker_config is not None and not checker_config.enable:
        return
    mode = _NanInfChecker()
    mode.__enter__()
    _checkers.append(mode)


def disable_tensor_checker():
    while _checkers:
        _checkers.pop().__exit__(None, None, None)


class OperatorStats:
    """What :func:`collect_operator_stats` saw: ``records``, one
    ``(op name, input dtypes, cast dtypes)`` a call, dtypes as strings
    (``"float32"``, ``"int64"``, ...), in call order."""

    def __init__(self):
        self.records = []

    def record(self, op_name, args, cast):
        names = tuple(str(a.dtype).replace("torch.", "") for a in args
                      if isinstance(a, torch.Tensor))
        cast_names = tuple(str(a.dtype).replace("torch.", "") for a in cast
                           if isinstance(a, torch.Tensor))
        self.records.append((op_name, names, cast_names))

    def counts(self):
        """``{op name: {dtype: calls}}``, by the dtype the op's first
        float input was cast to (Paddle's FP16/BF16/FP32 call table)."""
        out = {}
        for op, _, cast in self.records:
            first = next((d for d in cast if d.startswith(("float",
                                                           "bfloat"))),
                         "other")
            out.setdefault(op, Counter())[first] += 1
        return {op: dict(c) for op, c in out.items()}


@contextlib.contextmanager
def collect_operator_stats():
    """Record every op dispatched through the AMP policy inside the
    region (AMP on or off); yields the :class:`OperatorStats`."""
    stats = OperatorStats()
    _recorders.append(stats)
    try:
        yield stats
    finally:
        _recorders.remove(stats)


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "compare_accuracy needs the static dump pipeline; use "
        "check_numerics / enable_tensor_checker")
