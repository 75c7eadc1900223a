"""Attention functional (port of the plain path of
``paddle_tpu/nn/functional/common.py:571``)."""
from __future__ import annotations

import math

import torch


def scaled_dot_product_attention(query, key, value, is_causal=False):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors, with
    grouped-query heads (``key`` may have fewer heads than ``query``) and
    bottom-right causal alignment when ``seq_q != seq_k``.

    Where the reference takes its flash kernel (no mask, ``seq_q >= 128``
    and ``head_dim % 64 == 0``) a CUDA tensor raises: that kernel is not
    ported yet, and the plain path is no stand-in for it. Elsewhere the
    plain grouped einsum runs, with the softmax in float32."""
    sq, d = query.shape[1], query.shape[-1]
    if query.is_cuda and sq >= 128 and d % 64 == 0:
        raise NotImplementedError("flash attention kernel: next slice")
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (query, key, value))
    b, hq = qt.shape[:2]
    hk = kt.shape[1]
    qg = qt.reshape(b, hk, hq // hk, *qt.shape[2:])
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt) * scale
    if is_causal:
        sk = logits.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=query.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vt)
    return out.reshape(b, hq, sq, d).transpose(1, 2)
