"""Fused transformer ops (port of ``paddle_tpu/ops/fused.py``): RoPE tables
and rotation, SwiGLU. Plain PyTorch: on the TPU these were XLA-level ops,
not Pallas kernels. Each is the reference's op (``"fused_rope"``,
``"fused_swiglu"``): its tensor inputs cast by the AMP policy, mixed
float dtypes promoted as jnp promotes them."""
from __future__ import annotations

import torch

from .. import amp


def rope_freqs(head_dim, max_position, base=10000.0, device=None):
    """RoPE cos/sin tables of shape [max_position, head_dim], float32, in
    the neox layout: the frequencies repeat over the two halves."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    t = torch.arange(max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)                       # [S, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)           # [S, D]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def fused_rotary_position_embedding(q, k, sin, cos, position_ids=None):
    """Rotate q and k, both ``[batch, seq, heads, head_dim]``, by the
    neox (half-split) convention: ``x * cos + rotate_half(x) * sin``,
    where ``rotate_half`` maps halves ``(a, b)`` to ``(-b, a)``.
    ``position_ids`` ([seq] or [batch, seq]) picks rows of the tables;
    without it the first ``seq`` rows are used. The tables are float32,
    so the rotation of a bf16 or fp16 ``x`` is computed and returned in
    float32, as jnp promotes ``x * cos`` in the reference (``:55``)."""
    q, k = amp.amp_cast_inputs("fused_rope", [q, k])
    s = q.shape[1]
    if position_ids is not None:
        cs, sn = cos[position_ids], sin[position_ids]   # [(b,) s, d]
    else:
        cs, sn = cos[:s], sin[:s]
    cs, sn = cs.unsqueeze(-2), sn.unsqueeze(-2)         # [.., s, 1, d]

    def rot(x):
        xf, c, n = amp.promote(x, cs, sn)
        return xf * c + _rotate_half(xf) * n

    return rot(q), rot(k)


def fused_swiglu(x, gate):
    """swiglu(x, gate) = silu(x) * gate, with silu written as the
    reference writes it: ``x * (1 / (1 + exp(-x)))``, returned in ``x``'s
    dtype."""
    x, gate = amp.amp_cast_inputs("fused_swiglu", [x, gate])
    xs = x * (1.0 / (1.0 + torch.exp(-x)))
    return torch.mul(*amp.promote(xs, gate)).to(x.dtype)
