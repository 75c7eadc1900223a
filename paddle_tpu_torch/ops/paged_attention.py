"""Paged decode attention: one query token per sequence over its paged KV
context (port of ``paddle_tpu/ops/pallas/paged_attention.py``).

The KV cache lives in fixed-size pages in kv-head-major layout
``[kv_heads, num_pages, page_size, head_dim]``; a per-sequence block
table maps logical positions to pages (unused entries 0, a valid page),
and ``context_lens[b]`` counts the tokens sequence ``b`` sees, this one
included. Positions at or past it score ``-inf``, the reference's mask
for this kernel.

Pages are native (the query's dtype, kernel B4) or int8 with one fp32
scale per ``(kv head, page, slot)`` row (kernel B5), each row
dequantised in fp32 as ``int8 * scale`` before both dots.

A CUDA tensor goes to the kernel (``csrc/paged_attention.cu``) or
raises; a CPU tensor runs :func:`paged_decode_plain`, the kernel's
recurrence in PyTorch. The reference's XLA and production-kernel tiers
are not Pallas and have no counterpart.
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
                       sm_scale, k_scales=None, v_scales=None):
    """The kernel's recurrence: every sequence and kv head at once, one
    page column at a time, online softmax in fp32. It stops at the
    longest context's last page; a page past a sequence's context is
    fully masked and leaves its state unchanged bit for bit. With
    ``k_scales``/``v_scales`` the pages are int8 codes, each gathered
    page dequantised as the reference's ``_decode_kernel_quant`` does
    (``:116-117``)."""
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
        k, v = k_pages[:, page].float(), v_pages[:, page].float()
        if k_scales is not None:
            k = k * k_scales[:, page][..., None]
            v = v * v_scales[:, page][..., None]
        k, v = k.transpose(0, 1), v.transpose(0, 1)      # [B, KVH, P, D]
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


def _check_cuda_inputs(q, k_pages, v_pages, tables, ctx, k_scales,
                       v_scales):
    quant = k_scales is not None
    page_dtype = torch.int8 if quant else q.dtype
    operands = [("q", q, q.dtype), ("k_pages", k_pages, page_dtype),
                ("v_pages", v_pages, page_dtype)]
    if quant:
        operands += [("k_scales", k_scales, torch.float32),
                     ("v_scales", v_scales, torch.float32)]
        if k_scales.shape != k_pages.shape[:3] \
                or v_scales.shape != k_scales.shape:
            raise ValueError(f"scales {tuple(k_scales.shape)}, "
                             f"{tuple(v_scales.shape)} do not fit pages "
                             f"{tuple(k_pages.shape)}")
    for name, t, dtype in operands:
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected "
                             f"{dtype} on {q.device}")
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


def _launch(fn_name, q, pages, tables, ctx, sm_scale):
    B, H, _ = q.shape
    KVH, NP, P, D = pages[0].shape
    out = torch.empty_like(q)
    args = ([ctypes.c_int(_build.dtype_code(q.dtype))]
            + [ctypes.c_void_p(t.data_ptr())
               for t in (q, *pages, out, tables, ctx)]
            + [ctypes.c_int(x) for x in (B, H, KVH, D, NP, P,
                                         tables.shape[1])]
            + [ctypes.c_float(sm_scale)])
    _build.launch(fn_name, q.device, args)
    return out


def _paged_cuda(q, k_pages, v_pages, tables, ctx, sm_scale):
    _check_cuda_inputs(q, k_pages, v_pages, tables, ctx, None, None)
    out = _launch("ptt_paged_decode", q, (k_pages, v_pages), tables, ctx,
                  sm_scale)
    paged_attention.launches += 1
    return out


def paged_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, context_lens, sm_scale):
    """Kernel B5: :func:`paged_attention` over int8 pages ``[KVH, NP, P,
    D]`` with fp32 row scales ``[KVH, NP, P]``. A CPU tensor runs
    :func:`paged_decode_plain`; CUDA launches are counted in
    ``paged_attention_q8.launches``."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  context_lens, sm_scale, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    tables = _as_int32(block_tables, q.device)
    ctx = _as_int32(context_lens, q.device)
    _check_cuda_inputs(q, k_pages, v_pages, tables, ctx, k_scales, v_scales)
    out = _launch("ptt_paged_decode_q8", q,
                  (k_pages, v_pages, k_scales, v_scales), tables, ctx,
                  sm_scale)
    paged_attention_q8.launches += 1
    return out


paged_attention_q8.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    sm_scale=None, k_scales=None, v_scales=None):
    """One-token decode attention over a paged KV cache.

    q               [batch, heads, head_dim]
    k_pages/v_pages [kv_heads, num_pages, page_size, head_dim]
    block_tables    [batch, pages_per_seq] int32 (unused entries = 0),
                    tensor or array
    context_lens    [batch] int32, tokens in context including this one
    k_scales/v_scales [kv_heads, num_pages, page_size] float32 row scales
                    of int8 pages (None: native pages)
    -> [batch, heads, head_dim] in q's dtype.

    Native pages run B4, whose CUDA launches are counted in
    ``paged_attention.launches``; int8 pages run B5
    (:func:`paged_attention_q8`)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need both k_scales and v_scales")
    if k_scales is not None:
        return paged_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                                  block_tables, context_lens,
                                  float(sm_scale))
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
