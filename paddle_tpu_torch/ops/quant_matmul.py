"""Weight-only int8 matmul (port of
``paddle_tpu/ops/pallas/quant_matmul.py``).

A weight is stored as int8 codes ``[N, K]`` (torch's ``[out, in]``
Linear layout; the reference keeps ``[K, N]``) and one fp32 scale per
output channel ``[N]``. The product ``x @ (q * scale).T`` is computed as
the reference's kernel computes it: both operands in fp32, an fp32
accumulator over the whole K reduction, times ``scale[n]`` once at the
end, then cast to x's dtype. There is no int8 x int8 product.

A CUDA tensor goes to kernel B10 (``csrc/quant_matmul.cu``) or raises; a
CPU tensor runs :func:`int8_matmul_plain`. The reference's
dequantise-and-matmul fallback behind its compile guard has no
counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def quantize_weight(w):
    """``w [N, K]`` float -> ``(int8 [N, K], float32 scale [N])``,
    symmetric per output channel (abs-max over K). As in the reference
    (``quant_matmul.py:130-136``) the arithmetic runs in the weight's own
    dtype: for a bf16 weight the abs-max, the ``/ 127``, the division and
    the rounding (half to even) are bf16, and only the scale returned is
    upcast to fp32. The divisor is a tensor: a Python scalar would let
    CUDA multiply by its reciprocal instead of dividing."""
    amax = w.abs().amax(1).clamp_min(1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def int8_matmul_plain(x, w_int8, scale):
    """``x [M, K]`` float, ``w_int8 [N, K]`` int8, ``scale [N]`` fp32 ->
    ``[M, N]`` in x's dtype: fp32 operands, fp32 accumulation, the scale
    applied to the accumulator, then the cast."""
    acc = x.float() @ w_int8.float().t()
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x, w_int8, scale):
    """Kernel B10: ``x [M, K]`` (fp32, bf16 or fp16) times the int8
    weight ``w_int8 [N, K]`` with per-channel ``scale [N]`` -> ``[M, N]``
    in x's dtype. A CPU tensor runs :func:`int8_matmul_plain`; CUDA
    launches are counted in ``int8_matmul.launches``."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_int8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul for device {x.device}")
    code = _build.dtype_code(x.dtype)
    for name, t, dtype in (("w_int8", w_int8, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{dtype} on {x.device}")
    if x.dim() != 2 or w_int8.dim() != 2 or x.shape[1] != w_int8.shape[1] \
            or tuple(scale.shape) != (w_int8.shape[0],):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_int8 "
                         f"{tuple(w_int8.shape)}, scale {tuple(scale.shape)}")
    x, w_int8 = x.contiguous(), w_int8.contiguous()
    scale = scale.contiguous()
    if w_int8.data_ptr() % 16:
        w_int8 = w_int8.clone()         # the kernel loads 16-byte rows
    (M, K), N = x.shape, w_int8.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    args = ([ctypes.c_int(code)]
            + [ctypes.c_void_p(t.data_ptr()) for t in (x, w_int8, scale, out)]
            + [ctypes.c_int(v) for v in (M, N, K)])
    _build.launch("ptt_int8_matmul", x.device, args)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
