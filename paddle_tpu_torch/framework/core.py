"""The current device and ``to_tensor`` (Paddle's ``set_device``,
``get_device``, ``paddle.to_tensor``).

The default device is ``"gpu:0"``, CUDA. A creation op or ``to_tensor``
that would place a tensor on CUDA where there is none raises
``RuntimeError`` unless ``set_device("cpu")`` was called: the port never
moves to the CPU unasked. Tensors are ``torch.Tensor``; Paddle's
``Tensor`` class and its methods are not ported yet."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from . import dtype as dtypes

_device = "gpu:0"


class Place:
    """A device place: ``kind`` ``"cpu"`` or ``"gpu"`` (CUDA) and its
    index."""

    def __init__(self, kind, index=0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        return isinstance(other, Place) and (self.kind, self.index) == (
            other.kind, other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    def torch_device(self):
        return torch.device("cpu" if self.kind == "cpu"
                            else f"cuda:{self.index}")


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu")


class CUDAPlace(Place):
    """The accelerator's place (the reference's ``TPUPlace``)."""

    def __init__(self, index=0):
        super().__init__("gpu", index)


def place_of(device):
    """The ``Place`` of a ``torch.device``."""
    return CPUPlace() if device.type == "cpu" else CUDAPlace(
        device.index or 0)


def is_compiled_with_cuda():
    """True where torch was built with CUDA (the card may still be
    absent; ``device_count`` says how many there are)."""
    return torch.version.cuda is not None


def is_compiled_with_xpu():
    return False


def device_count():
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def _parse(device):
    kind, _, idx = str(device).lower().partition(":")
    if kind in ("gpu", "cuda"):
        return f"gpu:{int(idx) if idx else 0}"
    if kind == "cpu":
        return "cpu"
    raise ValueError(f"unknown device {device!r}: expected 'cpu', 'gpu' "
                     f"or 'gpu:N'")


def set_device(device):
    """``"cpu"``, ``"gpu"`` or ``"gpu:N"`` (``"cuda"`` spellings too, or a
    ``Place``) becomes the device creation ops place their tensors on;
    returns it as a ``torch.device``."""
    global _device
    if isinstance(device, Place):
        device = f"{device.kind}:{device.index}"
    _device = _parse(device)
    return torch.device(_torch_name(_device))


def get_device():
    """``"cpu"`` or ``"gpu:N"``."""
    return _device


def _torch_name(device):
    return "cpu" if device == "cpu" else "cuda:" + device.split(":")[1]


def current_device():
    """The current device as a ``torch.device``; raises ``RuntimeError``
    when it is CUDA and CUDA is not available."""
    return resolve_device(_torch_name(_device))


def device_of(place=None):
    """``place`` (None: the current device; a string or ``torch.device``)
    -> ``torch.device``, with the same CUDA check."""
    if place is None:
        return current_device()
    if isinstance(place, torch.device):
        return resolve_device(place)
    if isinstance(place, Place):
        return resolve_device(place.torch_device())
    return resolve_device(_torch_name(_parse(place)))


def _default_dtype_for(data):
    """Paddle's dtype for Python data: floats take the default dtype,
    ints int64, bools bool, complex numbers complex64."""
    flat = np.asarray(data)
    if flat.dtype.kind == "f":
        return dtypes.default_float()
    if flat.dtype.kind == "c":
        return dtypes.complex64
    return None


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor -> a ``torch.Tensor`` on ``place`` (None: the
    current device) that requires grad when ``stop_gradient`` is False.
    numpy arrays and tensors keep their dtype, float64 included (ROADMAP
    C26); Python floats take the default dtype."""
    dev = device_of(place) if place is not None or not isinstance(
        data, torch.Tensor) else data.device
    dt = dtypes.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=dt or data.dtype, copy=True)
    elif isinstance(data, (np.ndarray, np.generic)):
        t = torch.from_numpy(np.array(data)).to(dev)
        if dt is not None:
            t = t.to(dt)
    else:
        t = torch.as_tensor(np.asarray(data)).to(dev)
        t = t.to(dt or _default_dtype_for(data) or t.dtype)
    if not stop_gradient:
        t.requires_grad_(True)
    return t
