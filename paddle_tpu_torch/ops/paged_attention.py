"""Paged decode attention: one query token per sequence over its paged KV
context (port of ``paddle_tpu/ops/pallas/paged_attention.py``).

The KV cache lives in fixed-size pages in kv-head-major layout
``[kv_heads, num_pages, page_size, head_dim]``; a per-sequence block
table maps logical positions to pages (unused entries 0, a valid page),
and ``context_lens[b]`` counts the tokens sequence ``b`` sees, this one
included. Positions at or past it score ``-inf``, the reference's mask
for this kernel.

Pages are native (kernel B4: the query's dtype, or fp32 under a bf16
or fp16 query, as a 16-bit model's pools are under AMP's O2) or int8
with one fp32 scale per ``(kv head, page, slot)`` row (kernel B5), each
row dequantised in fp32 as ``int8 * scale`` before both dots. The
output takes the query's dtype; a 16-bit query is read exactly into
fp32, so over fp32 pages the result is the fp32 query's, rounded once.

A CUDA tensor goes to a kernel of ``csrc/paged_attention.cu`` or
raises; a CPU tensor runs :func:`paged_decode_plain`, the reference's
recurrence in PyTorch. The kernels come in two variants, chosen by
:func:`decode_variant` before the launch: ``"cluster"`` splits each
sequence's context across a thread-block cluster of
:func:`paged_decode_splits` blocks and merges their partial softmax
states in the same launch (:func:`paged_decode_split_model` is its
algorithm in PyTorch, for the tests); ``"block"`` runs one block per
(sequence, kv head) over the whole context, for the shapes the first
cannot take. The reference's XLA and production-kernel tiers are not
Pallas and have no counterpart.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

#: the reference's mask for positions past the context (``:52``)
NEG_INF = float("-inf")

#: the kernels' variants (see :func:`decode_variant`)
VARIANTS = ("cluster", "block")
#: the page size the ``"cluster"`` kernel takes, the consecutive pages
#: dealt to a split together (a chunk), and the most splits a sequence's
#: context takes (the portable cluster size)
SPLIT_PAGE, CHUNK_PAGES, MAX_SPLITS = 16, 2, 8
#: the widest head the ``"cluster"`` kernel takes (8 columns a lane, 32
#: lanes a key)
SPLIT_MAX_D = 256
#: the blocks an SM that :func:`paged_decode_splits` aims the grid at
SPLIT_BLOCKS_PER_SM = 2
#: dynamic shared memory a block may use on Hopper, and the ring depths
#: the ``"cluster"`` kernel tries, deepest first
SMEM_LIMIT = 232448
SPLIT_STAGES = (4, 3, 2)


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


def paged_decode_splits(batch, kv_heads, pages_per_seq, n_sm):
    """The ``"cluster"`` kernel's splits S per (sequence, kv head): enough
    that the grid of S x kv_heads x batch blocks gives each of the ``n_sm``
    SMs about SPLIT_BLOCKS_PER_SM, at most MAX_SPLITS and at most the
    table's chunks. Shapes alone decide it: the context lengths live on
    the device, and reading them would stall the host once a layer."""
    chunks = -(-pages_per_seq // CHUNK_PAGES)
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // max(batch * kv_heads, 1))
    return max(1, min(MAX_SPLITS, chunks, want))


def split_pages(split, splits, n_pages):
    """The pages below ``n_pages`` that split ``split`` of ``splits``
    walks, as its chunks in order: CHUNK_PAGES consecutive pages a chunk,
    chunk k to split k mod ``splits``. A split past the last chunk gets
    none."""
    n_chunks = -(-n_pages // CHUNK_PAGES)
    return [list(range(k * CHUNK_PAGES, min((k + 1) * CHUNK_PAGES, n_pages)))
            for k in range(split, n_chunks, splits)]


def split_partial(qg, k_pages, v_pages, row, steps, limit, sm_scale,
                  k_scales=None, v_scales=None):
    """One split's partial state over its steps (lists of pages of the
    table row ``row``, each step one online-softmax update over its
    pages' keys) in fp32, keys at or past ``limit`` masked. ``qg`` [KVH,
    G, D]; returns m, l [KVH, G, 1] and acc [KVH, G, D] (m -inf, l and acc
    0 for a split with no step)."""
    KVH, G, D = qg.shape
    P = k_pages.shape[2]
    m = torch.full((KVH, G, 1), NEG_INF, device=qg.device)
    l = torch.zeros((KVH, G, 1), device=qg.device)
    acc = torch.zeros((KVH, G, D), device=qg.device)
    for pages in steps:
        ids = torch.as_tensor(np.asarray(row)[pages].astype(np.int64),
                              device=qg.device)
        k, v = k_pages[:, ids].float(), v_pages[:, ids].float()
        if k_scales is not None:
            k = k * k_scales[:, ids][..., None]
            v = v * v_scales[:, ids][..., None]
        k, v = k.reshape(KVH, -1, D), v.reshape(KVH, -1, D)
        pos = (torch.as_tensor(pages, device=qg.device)[:, None] * P
               + torch.arange(P, device=qg.device)).reshape(-1)
        s = (qg @ k.transpose(-1, -2)) * sm_scale          # [KVH, G, keys]
        s = torch.where(pos < limit, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        w = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + w.sum(-1, keepdim=True)
        acc = acc * corr + w @ v
        m = m_new
    return m, l, acc


def merge_partials(parts):
    """The splits' partials (m, l, acc) merged in split order: M = max
    m_s, L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) / max(L,
    1e-30); an empty split (m_s = -inf) is skipped."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.where(torch.isneginf(m), 0.0, torch.exp(m - M))
        L = L + l * f
        A = A + acc * f
    return A / L.clamp_min(1e-30)


def paged_decode_split_model(q, k_pages, v_pages, block_tables, context_lens,
                             sm_scale, splits, k_scales=None, v_scales=None,
                             stages=SPLIT_STAGES[0]):
    """The ``"cluster"`` kernel's algorithm in fp32 PyTorch, for the tests
    and the chip check (no main path runs it): per sequence, each of
    ``splits`` splits runs :func:`split_partial` over the chunks
    :func:`split_pages` deals it, one online-softmax update per round of
    ``stages`` chunks (the kernel's resident ring), and
    :func:`merge_partials` merges them in split order. Same arguments as
    :func:`paged_decode_plain`."""
    B, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    tables = np.asarray(block_tables.cpu() if isinstance(
        block_tables, torch.Tensor) else block_tables)
    lens = np.asarray(context_lens.cpu() if isinstance(
        context_lens, torch.Tensor) else context_lens).reshape(-1)
    qg = q.float().view(B, KVH, G, D)
    outs = []
    for b in range(B):
        ctx = int(lens[b])
        n_pages = min(-(-ctx // P), tables.shape[1])
        limit = min(ctx, n_pages * P)
        parts = []
        for s in range(splits):
            chunks = split_pages(s, splits, n_pages)
            rounds = [sum(chunks[i:i + stages], [])
                      for i in range(0, len(chunks), stages)]
            parts.append(split_partial(qg[b], k_pages, v_pages, tables[b],
                                       rounds, limit, sm_scale, k_scales,
                                       v_scales))
        outs.append(merge_partials(parts))
    return torch.stack(outs).reshape(B, H, D).to(q.dtype)


def split_smem_bytes(el, quant, G, D, pages_per_seq, splits, stages):
    """Dynamic shared memory of one ``"cluster"`` block (the formula of
    ``split_smem_bytes`` in ``csrc/paged_attention.cu``): the stages'
    mbarriers, a ring of ``stages`` chunks of K and V pages of ``el``-byte
    values (and their int8 row scales), q, acc, a round's scores and the
    row state in fp32, and the split's table entries."""
    slab = SPLIT_PAGE * D * el
    chunks = -(-pages_per_seq // CHUNK_PAGES)
    cap = CHUNK_PAGES * -(-chunks // splits)
    keys = CHUNK_PAGES * SPLIT_PAGE
    return (-(-8 * stages // 16) * 16 + stages * 2 * CHUNK_PAGES * slab
            + (stages * 2 * keys * 4 if quant else 0)
            + 4 * (2 * G * D + G * stages * keys + 3 * G) + 4 * cap)


def split_stages(el, quant, G, D, pages_per_seq, splits):
    """The deepest ring of SPLIT_STAGES whose block fits SMEM_LIMIT, or 0
    when none does."""
    for stages in SPLIT_STAGES:
        if split_smem_bytes(el, quant, G, D, pages_per_seq, splits,
                            stages) <= SMEM_LIMIT:
            return stages
    return 0


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_variant(q, k_pages, v_pages, pages_per_seq, n_sm, k_scales=None,
                   v_scales=None):
    """The rule: ``("cluster", splits, stages)`` when the ``"cluster"``
    kernel takes these operands (page size SPLIT_PAGE, head_dim % 16 ==
    0 and <= SPLIT_MAX_D, every pool and scale array 16-byte aligned, a
    ring that fits shared memory), else ``("block", 0, 0)``. Depends on
    shapes, types and addresses only."""
    B, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    quant = k_scales is not None
    pools = [t for t in (k_pages, v_pages, k_scales, v_scales)
             if t is not None]
    if P != SPLIT_PAGE or D % 16 or D > SPLIT_MAX_D or H % KVH \
            or pages_per_seq < 1 or any(t.data_ptr() % 16 for t in pools):
        return "block", 0, 0
    splits = paged_decode_splits(B, KVH, pages_per_seq, n_sm)
    stages = split_stages(k_pages.element_size(), quant, H // KVH, D,
                          pages_per_seq, splits)
    return ("cluster", splits, stages) if stages else ("block", 0, 0)


def _check_cuda_inputs(q, k_pages, v_pages, tables, ctx, k_scales,
                       v_scales):
    quant = k_scales is not None
    # native pages of q's dtype, or fp32 under a 16-bit q (AMP's O2 casts
    # q alone); int8 pages under any q
    page_dtype = torch.int8 if quant else k_pages.dtype
    _build.attention_dtype_code(q.dtype, page_dtype)
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


def dtype_key(q, k_pages):
    """The key of a wrapper's ``launches_by_dtype``: ``"<q>/<pages>"``, as
    ``"bfloat16/bfloat16"`` (the instantiation ``<T, PT>``)."""
    return "/".join(str(t.dtype).replace("torch.", "") for t in (q, k_pages))


def launch_counters(fn, variant, q, k_pages, quant):
    """The counters a launch of wrapper ``fn``'s ``variant`` adds to:
    every launch, the variant's, its dtypes' in ``launches_by_dtype``
    (:func:`dtype_key`), and for a 16-bit q over fp32 pages (the
    ``<T, float>`` instantiations) ``mixed_launches``."""
    out = ((fn, "launches"), (fn, f"{variant}_launches"),
           (fn.launches_by_dtype, dtype_key(q, k_pages)))
    if k_pages.dtype != q.dtype and not quant:
        out += ((fn, "mixed_launches"),)
    return out


def _paged_cuda(fn, q, k_pages, v_pages, block_tables, context_lens,
                sm_scale, k_scales, v_scales, variant):
    """Check, pick the variant (or take the forced one), launch, count:
    ``fn`` is the wrapper whose counters the launch adds to."""
    tables = _as_int32(block_tables, q.device)
    ctx = _as_int32(context_lens, q.device)
    _check_cuda_inputs(q, k_pages, v_pages, tables, ctx, k_scales, v_scales)
    B, H, _ = q.shape
    KVH, NP, P, D = k_pages.shape
    rule, splits, stages = decode_variant(
        q, k_pages, v_pages, tables.shape[1], _sm_count(q.device.index),
        k_scales, v_scales)
    if variant == "cluster" and rule != "cluster":
        raise ValueError(f"the cluster kernel does not take pages "
                         f"{tuple(k_pages.shape)} with q {tuple(q.shape)}")
    variant = variant or rule
    quant = k_scales is not None
    pools = (k_pages, v_pages) + ((k_scales, v_scales) if quant else ())
    name = "ptt_paged_decode" + ("_split" if variant == "cluster" else "") \
        + ("_q8" if quant else "")
    out = torch.empty_like(q)
    args = ([ctypes.c_int(_build.attention_dtype_code(q.dtype,
                                                      k_pages.dtype))]
            + [ctypes.c_void_p(t.data_ptr())
               for t in (q, *pools, out, tables, ctx)]
            + [ctypes.c_int(x) for x in (B, H, KVH, D, NP, P,
                                         tables.shape[1])]
            + [ctypes.c_float(sm_scale)]
            + ([ctypes.c_int(splits), ctypes.c_int(stages)]
               if variant == "cluster" else []))
    _build.launch(name, q.device, args,
                  launch_counters(fn, variant, q, k_pages, quant))
    return out


def paged_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, context_lens, sm_scale, variant=None):
    """Kernel B5: :func:`paged_attention` over int8 pages ``[KVH, NP, P,
    D]`` with fp32 row scales ``[KVH, NP, P]``. A CPU tensor runs
    :func:`paged_decode_plain`; CUDA launches are counted in
    ``paged_attention_q8.launches`` and, by variant, in
    ``.cluster_launches`` and ``.block_launches``."""
    if variant not in (None, *VARIANTS):
        raise ValueError(f"variant {variant!r}, expected one of {VARIANTS}")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  context_lens, sm_scale, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    return _paged_cuda(paged_attention_q8, q, k_pages, v_pages, block_tables,
                       context_lens, sm_scale, k_scales, v_scales, variant)


paged_attention_q8.launches = 0
paged_attention_q8.cluster_launches = 0
paged_attention_q8.block_launches = 0
paged_attention_q8.launches_by_dtype = {}


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    sm_scale=None, k_scales=None, v_scales=None,
                    variant=None):
    """One-token decode attention over a paged KV cache.

    q               [batch, heads, head_dim]
    k_pages/v_pages [kv_heads, num_pages, page_size, head_dim]
    block_tables    [batch, pages_per_seq] int32 (unused entries = 0),
                    tensor or array
    context_lens    [batch] int32, tokens in context including this one
    k_scales/v_scales [kv_heads, num_pages, page_size] float32 row scales
                    of int8 pages (None: native pages)
    variant         None (the rule, :func:`decode_variant`), or
                    ``"cluster"`` / ``"block"`` to force one kernel (a
                    forced ``"cluster"`` raises where it does not apply);
                    CUDA tensors only
    -> [batch, heads, head_dim] in q's dtype.

    Native pages run B4, whose CUDA launches are counted in
    ``paged_attention.launches`` and, by variant, in
    ``.cluster_launches`` and ``.block_launches``, by dtypes in
    ``.launches_by_dtype``; those of a 16-bit q over fp32 pages (the ``<T, float>`` instantiations) also in
    ``.mixed_launches``. int8 pages run B5 (:func:`paged_attention_q8`)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if variant not in (None, *VARIANTS):
        raise ValueError(f"variant {variant!r}, expected one of {VARIANTS}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need both k_scales and v_scales")
    if k_scales is not None:
        return paged_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                                  block_tables, context_lens,
                                  float(sm_scale), variant)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  context_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    return _paged_cuda(paged_attention, q, k_pages, v_pages, block_tables,
                       context_lens, float(sm_scale), None, None, variant)


paged_attention.launches = 0
paged_attention.cluster_launches = 0
paged_attention.block_launches = 0
paged_attention.mixed_launches = 0
paged_attention.launches_by_dtype = {}


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
