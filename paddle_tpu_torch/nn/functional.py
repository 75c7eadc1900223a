"""Attention functional (port of
``paddle_tpu/nn/functional/common.py:571``)."""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import flash_attention


def scaled_dot_product_attention(query, key, value, is_causal=False):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors, with
    grouped-query heads (``key`` may have fewer heads than ``query``) and
    bottom-right causal alignment when ``seq_q != seq_k``.

    Where the reference takes its flash kernel (``seq_q >= 128`` and
    ``head_dim % 64 == 0``) this goes to :func:`flash_attention` on either
    device, with query ``i`` at position ``seq_k - seq_q + i``: the kernel
    on a CUDA tensor, its plain version on a CPU one; its gradient is the
    flash backward (B2 and B3 on a CUDA tensor). Elsewhere the plain
    grouped einsum runs, with the softmax in float32, differentiated by
    autograd. The reference's long-sequence chunked route is not
    ported."""
    sq, d = query.shape[1], query.shape[-1]
    if sq >= 128 and d % 64 == 0:
        return flash_attention(query, key, value, causal=is_causal,
                               q_offset=key.shape[1] - sq)
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
