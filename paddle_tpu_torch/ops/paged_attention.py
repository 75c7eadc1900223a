"""Paged decode attention: one query token per sequence over its paged KV
context (port of the native-page path of
``paddle_tpu/ops/pallas/paged_attention.py``).

The KV cache lives in fixed-size pages in kv-head-major layout
``[kv_heads, num_pages, page_size, head_dim]``; a per-sequence block
table maps logical positions to pages (unused entries 0, a valid page),
and ``context_lens[b]`` counts the tokens sequence ``b`` sees, this one
included. Positions at or past it score ``-inf``, the reference's mask
for this kernel.

A CUDA tensor goes to the kernel (``csrc/paged_attention.cu``) or
raises; a CPU tensor runs :func:`paged_decode_plain`, the kernel's
recurrence in PyTorch. The reference's XLA and production-kernel tiers
are not Pallas and have no counterpart; its int8 pages come with slice 4.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

#: the reference's mask for positions past the context (``:52``)
NEG_INF = float("-inf")


def _as_int32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def paged_decode_plain(q, k_pages, v_pages, block_tables, context_lens,
                       sm_scale):
    """The kernel's recurrence: every sequence and kv head at once, one
    page column at a time, online softmax in fp32. It stops at the
    longest context's last page; a page past a sequence's context is
    fully masked and leaves its state unchanged bit for bit."""
    B, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    tables = _as_int32(block_tables, q.device).long()
    ctx = _as_int32(context_lens, q.device)
    n_pages = min(-(-int(ctx.max()) // P), tables.shape[1]) if B else 0
    qg = q.float().view(B, KVH, G, D)
    ctx = ctx[:, None, None, None]
    m = torch.full((B, KVH, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, KVH, G, 1), device=q.device)
    acc = torch.zeros((B, KVH, G, D), device=q.device)
    iota = torch.arange(P, device=q.device, dtype=torch.int32)
    for p in range(n_pages):
        page = tables[:, p]
        k = k_pages[:, page].float().transpose(0, 1)     # [B, KVH, P, D]
        v = v_pages[:, page].float().transpose(0, 1)
        s = (qg @ k.transpose(-1, -2)) * sm_scale        # [B, KVH, G, P]
        s = torch.where(p * P + iota < ctx, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        w = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + w.sum(-1, keepdim=True)
        acc = acc * corr + w @ v
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _paged_cuda(q, k_pages, v_pages, tables, ctx, sm_scale):
    code = _build.dtype_code(q.dtype)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    B, H, D = q.shape
    KVH, NP, P, Dk = k_pages.shape
    if Dk != D or H % KVH or tables.dim() != 2 or tables.shape[0] != B \
            or tuple(ctx.shape) != (B,):
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(tables.shape)}, context_lens "
                         f"{tuple(ctx.shape)}")
    out = torch.empty_like(q)
    args = ([ctypes.c_int(code)]
            + [ctypes.c_void_p(t.data_ptr())
               for t in (q, k_pages, v_pages, out, tables, ctx)]
            + [ctypes.c_int(x) for x in (B, H, KVH, D, NP, P,
                                         tables.shape[1])]
            + [ctypes.c_float(sm_scale)])
    _build.launch("ptt_paged_decode", q.device, args)
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    sm_scale=None, k_scales=None, v_scales=None):
    """One-token decode attention over a paged KV cache.

    q               [batch, heads, head_dim]
    k_pages/v_pages [kv_heads, num_pages, page_size, head_dim]
    block_tables    [batch, pages_per_seq] int32 (unused entries = 0),
                    tensor or array
    context_lens    [batch] int32, tokens in context including this one
    -> [batch, heads, head_dim] in q's dtype.

    CUDA launches are counted in ``paged_attention.launches``."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError("int8 KV pages: slice 4 ports the "
                                  "quantized decode kernel")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  context_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    return _paged_cuda(q, k_pages, v_pages,
                       _as_int32(block_tables, q.device),
                       _as_int32(context_lens, q.device), float(sm_scale))


paged_attention.launches = 0


def paged_attention_reference(q, k_pages, v_pages, block_tables,
                              context_lens):
    """Dense oracle: per sequence, gather its context from the pages and
    run a plain softmax over it in fp32, scale ``1/sqrt(d)``."""
    B, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    tbl = np.asarray(block_tables.cpu() if isinstance(block_tables,
                                                      torch.Tensor)
                     else block_tables)
    lens = np.asarray(context_lens.cpu() if isinstance(context_lens,
                                                       torch.Tensor)
                      else context_lens).reshape(-1)
    outs = []
    for b in range(B):
        ctx = int(lens[b])
        pages = torch.as_tensor(tbl[b, :-(-ctx // P)].astype(np.int64),
                                device=q.device)
        ks = k_pages[:, pages].reshape(KVH, -1, D)[:, :ctx].float()
        vs = v_pages[:, pages].reshape(KVH, -1, D)[:, :ctx].float()
        qb = q[b].reshape(KVH, G, D).float()
        s = torch.einsum("kgd,ksd->kgs", qb, ks) / math.sqrt(D)
        o = torch.einsum("kgs,ksd->kgd", torch.softmax(s, -1), vs)
        outs.append(o.reshape(H, D))
    return torch.stack(outs).to(q.dtype)
