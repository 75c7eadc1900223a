"""Attention functional (port of
``paddle_tpu/nn/functional/common.py:571``): scaled dot-product attention
and its three routes."""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from .. import amp
from ..ops.flash_attention import NEG_INF, flash_attention

#: the reference's long-sequence thresholds (``common.py:615-617``): one
#: logits plane of at least 4096 x 4096, or at least 1 GiB of fp32
#: logits in all
CHUNKED_SEQ_PRODUCT = 4096 * 4096
CHUNKED_LOGITS_BYTES = 1 << 30
#: the chunked route's blocks: ``_xfa_blocks``'s defaults
#: (``flash_attention.py:520-523``)
CHUNK_Q, CHUNK_K = 512, 1024


def sdpa_route(q_shape, k_shape, has_mask=False, dropout=False):
    """The reference op a call takes, from shapes ``[b, s, h, d]`` alone:
    ``"flash_attn"`` with no mask, no active dropout, ``seq_q >= 128`` and
    ``head_dim % 64 == 0`` (``:583-588``; the reference also needs a TPU
    backend and ``FLAGS_use_flash_attention``, the port takes it on every
    device and has no flag); else ``"sdpa_chunked"`` with no mask, no
    active dropout, ``seq_q > 1`` and a large logits plane (``:609-617``);
    else ``"sdpa"``."""
    b, sq, hq, d = q_shape
    sk = k_shape[1]
    plain = not has_mask and not dropout
    if plain and sq >= 128 and d % 64 == 0:
        return "flash_attn"
    if plain and sq > 1 and (sq * sk >= CHUNKED_SEQ_PRODUCT
                             or b * hq * sq * sk * 4 >= CHUNKED_LOGITS_BYTES):
        return "sdpa_chunked"
    return "sdpa"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention over ``[batch, seq, heads, head_dim]`` tensors, with
    grouped-query heads (``key`` may have fewer heads than ``query``) and
    bottom-right causal alignment when ``seq_q != seq_k``. The route
    (:func:`sdpa_route`) names the op whose AMP policy casts the inputs:

    * ``"flash_attn"``: :func:`flash_attention` with query ``i`` at
      position ``seq_k - seq_q + i`` (the kernels B1, B2, B3 on a CUDA
      tensor, their plain versions on a CPU one). Inputs of mixed dtypes
      compute as the Pallas kernel does, which casts q, k and v to fp32
      (``flash_attention.py:141-143``): all go up exactly, the fp32
      kernels run, the output comes back in q's dtype and each gradient
      in its input's.
    * ``"sdpa_chunked"``: :func:`chunked_attention`, the counterpart of
      ``xla_attention``: plain torch, blocks of queries and keys, no
      ``seq_q x seq_k`` logits plane forward or backward.
    * ``"sdpa"``: the grouped einsum with the softmax in fp32; a bool
      ``attn_mask`` keeps the keys where it is True (the rest ``-inf``), a
      float one is added to the logits; with ``dropout_p > 0`` and
      ``training`` the weights are kept with probability ``1 - dropout_p``
      and scaled by ``1 / (1 - dropout_p)``, drawn from ``generator`` (a
      ``torch.Generator``; None: PyTorch's default one for the device).
      The reference draws from its JAX key stream; the port's draws
      reproduce within the port only (ROADMAP C2). Differentiated by
      autograd.
    """
    dropout = dropout_p > 0.0 and training
    route = sdpa_route(query.shape, key.shape, attn_mask is not None,
                       dropout)
    sq = query.shape[1]
    if route == "flash_attn":
        q, k, v = amp.amp_cast_inputs("flash_attn", [query, key, value])
        dt = q.dtype
        if not q.dtype == k.dtype == v.dtype:
            q, k, v = q.float(), k.float(), v.float()
        return flash_attention(q, k, v, causal=is_causal,
                               q_offset=key.shape[1] - sq).to(dt)
    if route == "sdpa_chunked":
        q, k, v = amp.amp_cast_inputs("sdpa_chunked", [query, key, value])
        q_off = key.shape[1] - sq if is_causal else 0
        return chunked_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=is_causal,
            q_offset=q_off).transpose(1, 2)
    args = amp.amp_cast_inputs("sdpa", [query, key, value] + (
        [attn_mask] if attn_mask is not None else []))
    q, k, v = args[:3]
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, hq = qt.shape[:2]
    hk, sk = kt.shape[1], kt.shape[2]
    qg = qt.reshape(b, hk, hq // hk, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", *amp.promote(qg, kt)) * scale
    logits = logits.reshape(b, hq, sq, sk)
    if is_causal:
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if len(args) > 3:
        mask = args[3]
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, float("-inf"))
        else:
            logits = torch.add(*amp.promote(logits, mask))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    pg = probs.reshape(b, hk, hq // hk, sq, sk)
    out = torch.einsum("bhgqk,bhkd->bhgqd", *amp.promote(pg, vt))
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def _blocks(sq, sk, block_q, block_k, causal, q_offset):
    """The chunked route's (q block, k block) visits: every k block of
    each q block, but those wholly in its causal future (they weigh 0
    and leave the running max, sum and output exactly as they were)."""
    bq, bk = min(block_q, sq), min(block_k, sk)
    for i in range(0, sq, bq):
        rows = min(bq, sq - i)
        last = q_offset + i + rows - 1
        yield i, rows, [(j, min(bk, sk - j)) for j in range(0, sk, bk)
                        if not causal or j <= last]


def _scores(qi, kf, i, j, cols, causal, q_offset, scale):
    s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kf[:, :, j:j + cols]) * scale
    if causal:
        qpos = q_offset + i + torch.arange(qi.shape[3], device=qi.device)
        kpos = j + torch.arange(cols, device=qi.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    return s


def _chunked_fwd(q, k, v, causal, q_offset, block_q, block_k):
    """``_xflash_fwd_impl`` (``flash_attention.py:526``) in kernel layout
    ``[b, h, s, d]``: online softmax over k blocks for each q block, the
    scores in fp32, the weights rounded to v's dtype before ``P V`` (fp32
    sums), rows with no valid key give 0 and lse ``NEG_INF``. Returns
    ``(out in q's dtype, lse fp32 [b, hq, sq])``."""
    b, hq, sq, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hk, g, sq, d)
    kf, vf = k.float(), v.float()
    out = torch.empty(b, hk, g, sq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hk, g, sq, dtype=torch.float32, device=q.device)
    for i, rows, visits in _blocks(sq, k.shape[2], block_q, block_k, causal,
                                   q_offset):
        qi = qg[:, :, :, i:i + rows].float()
        m = torch.full((b, hk, g, rows), NEG_INF, device=q.device)
        m_eff = torch.zeros_like(m)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hk, g, rows, d, device=q.device)
        for j, cols in visits:
            s = _scores(qi, kf, i, j, cols, causal, q_offset, scale)
            m_new = torch.maximum(m, s.amax(-1))
            m_eff = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_eff[..., None])
            alpha = torch.exp(m - m_eff)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                              vf[:, :, j:j + cols])
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        out[:, :, :, i:i + rows] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, :, :, i:i + rows] = torch.where(
            l <= 1e-30, NEG_INF, m_eff + torch.log(l_safe))
    return out.reshape(b, hq, sq, d), lse.reshape(b, hq, sq)


def _chunked_bwd(q, k, v, out, lse, dout, causal, q_offset, block_q,
                 block_k):
    """``_xflash_bwd_impl`` (``flash_attention.py:586``): the weights
    recomputed from lse block by block, ``ds = p (dp - delta) scale``, p
    rounded to v's dtype and ds to q's before their products, fp32 sums;
    each gradient in its input's dtype."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hk, g, sq, d)
    dog = dout.reshape(b, hk, g, sq, d)
    lseg = lse.reshape(b, hk, g, sq)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, hk, g, sq)
    kf, vf = k.float(), v.float()
    dq = torch.empty(b, hk, g, sq, d, dtype=q.dtype, device=q.device)
    dk = torch.zeros(b, hk, sk, d, device=q.device)
    dv = torch.zeros(b, hk, sk, d, device=q.device)
    for i, rows, visits in _blocks(sq, sk, block_q, block_k, causal,
                                   q_offset):
        qi = qg[:, :, :, i:i + rows].float()
        doi = dog[:, :, :, i:i + rows].float()
        lse_i = lseg[:, :, :, i:i + rows, None]
        live = (lse_i > NEG_INF / 2).float()
        delta_i = delta[:, :, :, i:i + rows, None]
        dq_i = torch.zeros(b, hk, g, rows, d, device=q.device)
        for j, cols in visits:
            s = _scores(qi, kf, i, j, cols, causal, q_offset, scale)
            p = torch.exp(s - lse_i) * live
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doi, vf[:, :, j:j + cols])
            ds = p * (dp - delta_i) * scale
            pc = p.to(v.dtype).float()
            dsc = ds.to(q.dtype).float()
            dq_i += torch.einsum("bhgqk,bhkd->bhgqd", dsc,
                                 kf[:, :, j:j + cols])
            dk[:, :, j:j + cols] += torch.einsum("bhgqk,bhgqd->bhkd", dsc, qi)
            dv[:, :, j:j + cols] += torch.einsum("bhgqk,bhgqd->bhkd", pc, doi)
        dq[:, :, :, i:i + rows] = dq_i.to(q.dtype)
    return dq.reshape(b, hq, sq, d), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_q, block_k):
        out, lse = _chunked_fwd(q, k, v, causal, q_offset, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_q, block_k)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_chunked_bwd(q, k, v, out, lse, dout, *ctx.args),
                None, None, None, None)


def chunked_attention(q, k, v, causal=True, q_offset=0, block_q=CHUNK_Q,
                      block_k=CHUNK_K):
    """Kernel-layout ``[b, h, s, d]`` attention in blocks of ``block_q``
    queries by ``block_k`` keys (the reference's ``xla_attention`` tier
    ``_xflash``; a ragged last block where the reference's tier would
    fall back to its q-chunked one, the same function). The largest
    temporary is one block's ``[b, h, block_q, block_k]`` fp32 scores,
    forward and backward. Differentiable in q, k and v."""
    return _ChunkedAttention.apply(q, k, v, bool(causal), int(q_offset),
                                   int(block_q), int(block_k))
