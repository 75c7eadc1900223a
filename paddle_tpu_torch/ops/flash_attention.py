"""Flash attention forward (port of the forward half of
``paddle_tpu/ops/pallas/flash_attention.py``).

Exact softmax attention over dense ``[batch, heads, seq, head_dim]``
tensors (the kernel layout; the public functions also take the
``[batch, seq, heads, head_dim]`` layout), returning the output and, for
online-softmax merging, the per-row log-sum-exp. Features of the
reference kept as they are:

* causal masking by global positions: query ``i`` sits at
  ``q_offset + i``, key ``j`` at ``kv_offset + j``, and sees keys with
  ``kv_offset + j <= q_offset + i``;
* grouped-query heads: query head ``h`` reads kv head ``h // group``;
* the finite mask ``NEG_INF = -1e30`` and the reference's tiling of
  128 x 128 (smaller for short sequences), which decides what a row with
  no valid key returns: its q-block's tiles still run, every masked key
  weighs ``exp(-1e30 - -1e30) = 1`` and the row gets the mean of V over
  the keys those tiles cover. The plain version walks the same tiles;
  the CUDA kernel (``csrc/flash_attention.cu``) tiles differently but
  visits the same keys per row, so it returns the same values.
  ``mha_reference`` zeroes such rows instead, as the reference's does.

A CUDA tensor goes to the kernel or raises; a CPU tensor runs
:func:`flash_attention_plain`. The backward kernels come with training:
a call that would need a gradient raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: the reference's finite mask (``flash_attention.py:43``)
NEG_INF = -1e30

#: the reference's default block sizes (``flash_attention.py:50-51``)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

#: head widths the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128, 192, 256)


def _cdiv(a, b):
    return (a + b - 1) // b


def ref_blocks(sq, sk):
    """The reference's tile shape for these lengths (``_fwd``, ``:177-178``):
    ``(block_q, block_k)``, each ``min(128, max(s, 8))``."""
    return (min(DEFAULT_BLOCK_Q, max(sq, 8)), min(DEFAULT_BLOCK_K, max(sk, 8)))


def mha_reference(q, k, v, causal=True, sm_scale=None, q_offset=0,
                  kv_offset=0, with_lse=False):
    """Dense attention in kernel layout ``[b, h, s, d]`` (GQA-aware), in
    fp32, rows with no valid key zeroed. Returns ``out`` or
    ``(out, lse)``; lse is fp32 ``[b, h, sq]``."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    g = hq // hk
    qg = q.float().reshape(b, hk, g, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * sm_scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :] + kv_offset
        logits = torch.where(qi >= ki, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    dead = m <= NEG_INF
    p = torch.where(dead, 0.0, torch.exp(logits - m))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l.clamp_min(1e-30)
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if not with_lse:
        return out
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    lse = torch.where(l[..., 0] <= 1e-30, NEG_INF, lse)
    return out, lse.reshape(b, hq, sq)


def flash_attention_plain(q, k, v, causal=True, sm_scale=None, q_offset=0,
                          kv_offset=0):
    """The reference kernel's recurrence in PyTorch (``_fwd_kernel``,
    ``:118-169``), kernel layout ``[b, h, s, d]``: q and k/v padded to
    whole tiles, one kv tile at a time for every q-block at once, a
    (q-block, kv-tile) pair updating its rows only where the reference
    runs it (its last query can see its first key). Returns ``(out,
    lse)``: out in q's dtype, lse fp32 ``[b, h, sq]``."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    g = hq // hk
    bq, bk = ref_blocks(sq, sk)
    sq_pad, sk_pad = _cdiv(sq, bq) * bq, _cdiv(sk, bk) * bk
    dev = q.device
    qf = torch.zeros((b, hq, sq_pad, d), device=dev)
    qf[:, :, :sq] = q.float()
    kf = torch.zeros((b, hk, sk_pad, d), device=dev)
    vf = torch.zeros((b, hk, sk_pad, d), device=dev)
    kf[:, :, :sk] = k.float()
    vf[:, :, :sk] = v.float()
    qg = qf.view(b, hk, g * sq_pad, d)
    rows = torch.arange(sq_pad, device=dev)
    q_ids = (q_offset + rows)[:, None]                        # [sq_pad, 1]
    last_q = (q_offset + (rows // bq) * bq + bq - 1)[:, None]
    m = torch.full((b, hk, g * sq_pad, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hk, g * sq_pad, 1), device=dev)
    acc = torch.zeros((b, hk, g * sq_pad, d), device=dev)
    for j in range(sk_pad // bk):
        k_local = j * bk + torch.arange(bk, device=dev)[None, :]
        kj, vj = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
        s = (qg @ kj.transpose(-1, -2)) * sm_scale            # [b,hk,g*sq,bk]
        mask = (k_local < sk).expand(sq_pad, bk)
        if causal:
            mask = mask & (q_ids >= kv_offset + k_local)
            run = (last_q >= kv_offset + j * bk).repeat(g, 1)  # [g*sq, 1]
        else:
            run = torch.ones((g * sq_pad, 1), dtype=torch.bool, device=dev)
        # rows of qg run (group, query): the [sq, bk] mask tiles g times
        s = torch.where(mask.repeat(g, 1), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = torch.where(run, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(run, acc * corr + p @ vj, acc)
        m = torch.where(run, m_new, m)
    out = acc / l.clamp_min(1e-30)
    lse = torch.where(l <= 1e-30, NEG_INF, m + torch.log(l.clamp_min(1e-30)))
    out = out.view(b, hq, sq_pad, d)[:, :, :sq].to(q.dtype)
    lse = lse.view(b, hq, sq_pad)[:, :, :sq]
    return out, lse


def _flash_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset, seq_dim):
    """Launch the kernel on tensors whose sequence axis is ``seq_dim`` (2
    in kernel layout, 1 in the public one), head_dim contiguous. Returns
    ``(out, lse)``, out in q's layout."""
    code = _build.dtype_code(q.dtype)
    head_dim = 3 - seq_dim
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, sq, hq = q.shape[0], q.shape[seq_dim], q.shape[head_dim]
    sk, hk, d = k.shape[seq_dim], k.shape[head_dim], q.shape[3]
    if k.shape[0] != b or k.shape[3] != d or hq % hk:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    strides = []
    for t in (q, k, v, out):
        st = t.stride()
        strides += [st[0], st[head_dim], st[seq_dim]]
    bq, bk = ref_blocks(sq, sk)
    args = ([ctypes.c_int(code)]
            + [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out, lse)]
            + [ctypes.c_longlong(s) for s in strides]
            + [ctypes.c_int(int(x)) for x in (b, hq, hk, sq, sk, d, q_offset,
                                              kv_offset, bool(causal), bq,
                                              bk)]
            + [ctypes.c_float(sm_scale)])
    _build.launch("ptt_flash_fwd", q.device, args)
    flash_attention.launches += 1
    return out, lse


def _forward(q, k, v, causal, sm_scale, q_offset, kv_offset, kernel_layout):
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward: slice 3 (training) ports it; call "
            "under torch.no_grad() or torch.inference_mode()")
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal, float(sm_scale), q_offset,
                           kv_offset, 2 if kernel_layout else 1)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    if not kernel_layout:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out, lse = flash_attention_plain(q, k, v, causal, sm_scale, q_offset,
                                     kv_offset)
    return (out if kernel_layout else out.transpose(1, 2)), lse


def flash_attention(q, k, v, causal=True, sm_scale=None, q_offset=0,
                    kv_offset=0, kernel_layout=False):
    """Flash attention. Layout ``[b, s, h, d]``, or ``[b, h, s, d]`` with
    ``kernel_layout=True``; the output comes back in the input's layout.
    CUDA launches are counted in ``flash_attention.launches``."""
    return _forward(q, k, v, causal, sm_scale, q_offset, kv_offset,
                    kernel_layout)[0]


flash_attention.launches = 0


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             q_offset=0, kv_offset=0):
    """Kernel-layout ``[b, h, s, d]`` flash attention returning ``(out,
    lse)``, lse fp32 ``[b, h, sq]`` (``NEG_INF`` for a row whose visited
    keys all carry no weight)."""
    return _forward(q, k, v, causal, sm_scale, q_offset, kv_offset, True)
