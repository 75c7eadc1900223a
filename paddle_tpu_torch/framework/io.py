"""``paddle.save`` and ``paddle.load`` (port of
``paddle_tpu/framework/io.py:17-80``): a pickle of nested dicts, lists
and tuples whose tensors are ``_TensorPayload`` records (a numpy array,
whether it was a parameter, its name, its ``stop_gradient``).

:func:`load` reads the reference's files as well as the port's: its
unpickler maps the reference's ``paddle_tpu.framework.io._TensorPayload``
to this module's class, so nothing of ``paddle_tpu`` or JAX is imported.
Tensors come back as torch tensors on ``device`` (a parameter as an
``nn.Parameter``), or as numpy arrays with ``return_numpy=True``. numpy
has no bf16, so the port stores a bf16 tensor's bits as int16 with its
dtype's name beside them; ``return_numpy`` gives such a tensor as fp32.
A file the reference wrote from bf16 tensors holds ``ml_dtypes`` arrays
and needs that package to load. Unpickling runs code named in the file:
load only files that this program or the reference wrote.

:func:`save` writes a temporary file and then replaces the target, so a
writer killed mid-save never leaves a half-written file, as the
reference does.
"""
from __future__ import annotations

import os
import pickle
import threading

import numpy as np
import torch

from .._device import resolve_device

#: where the reference pickles its payload class
_REFERENCE_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    """Pickle-stable record of a tensor: ``dtype`` names the torch dtype
    when ``array`` holds its bits in another numpy type (bf16)."""

    def __init__(self, array, is_param, name, stop_gradient, dtype=None):
        self.array = array
        self.is_param = is_param
        self.name = name
        self.stop_gradient = stop_gradient
        self.dtype = dtype


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _REFERENCE_PAYLOAD:
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        dtype = None
        if t.dtype == torch.bfloat16:
            t, dtype = t.view(torch.int16), "bfloat16"
        return _TensorPayload(t.numpy().copy(),
                              isinstance(obj, torch.nn.Parameter),
                              getattr(obj, "name", None),
                              not obj.requires_grad, dtype)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _tensor(payload, device):
    t = torch.from_numpy(np.array(payload.array))
    if getattr(payload, "dtype", None) == "bfloat16":
        t = t.view(torch.bfloat16)
    t = t.to(device)
    if payload.is_param:
        return torch.nn.Parameter(t, requires_grad=t.is_floating_point())
    if t.is_floating_point() and not payload.stop_gradient:
        t.requires_grad_(True)
    return t


def _unpack(obj, device, return_numpy):
    if isinstance(obj, _TensorPayload):
        if not return_numpy:
            return _tensor(obj, device)
        if getattr(obj, "dtype", None) == "bfloat16":
            return _tensor(obj, "cpu").detach().float().numpy()
        return obj.array
    if isinstance(obj, dict):
        return {k: _unpack(v, device, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, device, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (tensors, nested dicts, lists, tuples, plain values)
    to ``path``, through a temporary file that then replaces it."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(_pack(obj), f, protocol=protocol)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load(path, device=None, return_numpy=False, **configs):
    """Read a file :func:`save` or the reference's ``paddle.save`` wrote.
    Tensors come back on ``device`` (None means ``"cuda"``; pass
    ``device="cpu"`` where there is none), or as numpy arrays with
    ``return_numpy=True``."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, dev, return_numpy)
