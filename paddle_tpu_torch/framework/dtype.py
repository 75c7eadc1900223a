"""Paddle's dtype spellings over torch dtypes: ``paddle.float32``-style
singletons, strings (``"float32"``, ``"bf16"``, ...) and numpy dtypes all
map to one ``torch.dtype``, and the default floating dtype that creation
ops use.

The reference narrows 64-bit types when JAX runs without x64
(``int64 -> int32``, ``float64 -> float32``); the port keeps them, as
Paddle specifies, and indexes with int64 (ROADMAP C26)."""
from __future__ import annotations

import numpy as np
import torch

bfloat16 = torch.bfloat16
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float16": float16, "fp16": float16, "half": float16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}

_default_dtype = "float32"


def convert_dtype(d):
    """Any dtype spelling (a string, a torch dtype, a numpy dtype or scalar
    type) -> the ``torch.dtype``; ``None`` stays ``None``."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        key = d.lower()
        if key not in _STR2DTYPE:
            raise TypeError(f"unknown dtype {d!r}")
        return _STR2DTYPE[key]
    try:
        name = np.dtype(d).name
    except TypeError:
        raise TypeError(f"unknown dtype {d!r}") from None
    if name not in _STR2DTYPE:
        raise TypeError(f"unknown dtype {d!r}")
    return _STR2DTYPE[name]


def dtype_name(d) -> str:
    """The ``'float32'``-style name of a dtype (Paddle's convention)."""
    return str(convert_dtype(d)).replace("torch.", "")


def set_default_dtype(d):
    """The floating dtype creation ops use when given none: float16,
    bfloat16, float32 or float64."""
    global _default_dtype
    dt = convert_dtype(d) if d is not None else float32
    if dt not in (float16, bfloat16, float32, float64):
        raise TypeError(f"set_default_dtype only supports floating dtypes, "
                        f"got {d}")
    _default_dtype = dtype_name(dt)


def get_default_dtype():
    return _default_dtype


def default_float():
    return convert_dtype(_default_dtype)
