"""Blockwise symmetric int8 wire codec (port of
``paddle_tpu/distributed/comm/quantization.py``, EQuARX-style,
arXiv:2506.17615), with torch ops on the tensor's own device.

The vector is cut into blocks of ``block_size``; each block carries one
fp32 scale ``max|block| / 127`` (1 where that is 0, including a scale
that underflows) and its values as int8 ``round(x / scale)``, half to
even, clipped to +-127. Its error is at most ``scale / 2`` an element.
Wire cost: 1 byte an element plus 4 a block (25.4 % of fp32 at 256).
Every division is a true division by a tensor, so the codes and scales
equal the reference's numpy codec bit for bit (a CUDA division by a
Python number multiplies by its reciprocal). ``bf16`` casts to bfloat16
on the wire (50 %), round to nearest even, as the reference's
``ml_dtypes`` cast.
"""
from __future__ import annotations

import torch

DEFAULT_BLOCK_SIZE = 256

#: quantization schemes of the comm layer; None / "" is fp32
SCHEMES = ("int8", "bf16")


def _flat32(arr):
    return torch.as_tensor(arr).reshape(-1).to(torch.float32)


#: elements a chunk of the codec works on at once, so that its
#: temporaries stay small beside a gradient bucket of a billion elements
CHUNK = 1 << 24


def quantize_blockwise(arr, block_size: int = DEFAULT_BLOCK_SIZE):
    """fp32 vector -> (int8 codes including the zero padding, fp32
    per-block scales), a chunk of blocks at a time."""
    x = _flat32(arr)
    pad = (-x.numel()) % block_size
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    blocks = x.view(-1, block_size)
    q = torch.empty(blocks.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(blocks.shape[0], dtype=torch.float32,
                         device=x.device)
    step = max(1, CHUNK // block_size)
    for lo in range(0, blocks.shape[0], step):
        b = blocks[lo:lo + step]
        s = b.abs().amax(dim=1) / torch.full((), 127.0, device=x.device)
        s = torch.where(s > 0, s, torch.ones_like(s))
        scales[lo:lo + step] = s
        q[lo:lo + step] = torch.round(b / s[:, None]).clamp_(-127, 127)
    return q.reshape(-1), scales


def dequantize_blockwise(q, scales, numel: int,
                         block_size: int = DEFAULT_BLOCK_SIZE):
    """Inverse of :func:`quantize_blockwise`: fp32 of ``numel``."""
    deq = q.reshape(-1, block_size).to(torch.float32)
    deq.mul_(scales[:, None])
    return deq.reshape(-1)[:numel]


def encode_wire(arr, scheme, block_size: int):
    """One rank's contribution for the wire: ``(payload, wire_bytes)``,
    the payload a tuple of a tag and tensors."""
    if scheme == "int8":
        q, scales = quantize_blockwise(arr, block_size)
        return ("int8", q, scales), q.numel() + 4 * scales.numel()
    if scheme == "bf16":
        b = _flat32(arr).to(torch.bfloat16)
        return ("bf16", b), 2 * b.numel()
    raise ValueError(f"unknown comm quantization scheme {scheme!r} "
                     f"(expected one of {SCHEMES})")


def decode_wire(payload, numel: int, block_size: int):
    tag = payload[0]
    if tag == "int8":
        return dequantize_blockwise(payload[1], payload[2], numel, block_size)
    if tag == "bf16":
        return payload[1].to(torch.float32)[:numel]
    raise ValueError(f"unknown wire payload tag {tag!r}")
