"""Blockwise ring attention on one device (port of the single-host part
of ``paddle_tpu/ops/pallas/ring_attention.py``).

The ring-attention schedule run block after block: causal attention of
``q`` at global position ``q_offset`` over a list of KV blocks, each at
its own global position, every block's normalised partial and per-row
log-sum-exp coming from kernel B1
(:func:`~paddle_tpu_torch.ops.flash_attention.flash_fwd` with
``q_offset`` / ``kv_offset``), the partials merged with the
online-softmax combine in plain torch, as the reference merges in jnp.
Long-context serving (``SlotPagedKVCache``'s sep modes) attends a
prompt's stripes this way.

Each partial runs B1's fp32 variant on q, k and v upcast to fp32, and its
output is rounded to q's dtype before the merge: the reference's kernel
upcasts its three inputs (``flash_attention.py:141-143``) and writes the
partial in q's dtype (``:165``), and its merge works in fp32
(``ring_attention.py:100``). So a 16-bit q under ``auto_cast`` over fp32
stripes computes as the reference's does, and B1 never sees mixed dtypes.

A row with no valid key in a block gets lse ``-1e30`` there (B1's finite
mask, ROADMAP C10): the merge weighs that partial by ``exp(-1e30 -
lse) = 0`` as soon as another block holds a valid key. A row dead in
every block follows the reference's arithmetic (``logaddexp`` of equal
values).

The reference's ``ring_flash_attention`` (``shard_map`` and ``ppermute``
over the ``sep`` mesh axis) and its ``PADDLE_SEP_RING_IMPL`` tiers have
no counterpart here: a CPU tensor runs B1's plain version and a CUDA
tensor B1, and the ring across devices comes with torch.distributed.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import NEG_INF, flash_fwd

__all__ = ["ring_partial", "blockwise_causal_attention"]


def _merge(out, lse, out_i, lse_i):
    """Online-softmax merge of two normalised partials (kernel layout):
    ``out [b, h, sq, d]`` and ``lse [b, h, sq]``, fp32."""
    new_lse = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - new_lse)[..., None]
    w_i = torch.exp(lse_i - new_lse)[..., None]
    return out * w + out_i * w_i, new_lse


def ring_partial(q, k, v, q_offset, kv_offset, sm_scale):
    """One ring step: the normalised causal partial of ``q`` (kernel
    layout ``[b, h, sq, d]``, global position ``q_offset``) against one
    KV block ``[b, hk, sk, d]`` at ``kv_offset``. Returns ``(out, lse)``:
    out in q's dtype, lse fp32 ``[b, h, sq]``. B1 runs in fp32 on the
    upcast inputs (a no-op for fp32 ones)."""
    out, lse = flash_fwd(q.float(), k.float(), v.float(), True,
                         float(sm_scale), int(q_offset), int(kv_offset),
                         True)
    return out.to(q.dtype), lse


def blockwise_causal_attention(q, q_offset, kv_blocks, sm_scale=None):
    """Causal attention of ``q`` (kernel layout ``[b, h, sq, d]`` at global
    position ``q_offset``) over ``kv_blocks``, a list of ``(k, v,
    kv_offset)`` triples (one ring step each), merged block by block.
    Returns ``[b, h, sq, d]`` in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                     device=q.device)
    for k, v, kv_offset in kv_blocks:
        out_i, lse_i = ring_partial(q, k, v, q_offset, kv_offset, sm_scale)
        out, lse = _merge(out, lse, out_i.float(), lse_i)
    return out.to(q.dtype)
