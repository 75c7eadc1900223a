"""Flash attention forward and backward (port of
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
* the reference's backward (``_bwd``, ``:326-418``): the weights are
  recomputed from lse, ``p = exp(s - lse)`` on valid keys and 0 on
  masked ones, so a row with no valid key gets zero dq and adds nothing
  to dk or dv, whatever its forward returned. Autograd of the forward
  would not give that, so the gradient is always this backward (B1's
  registered backward), on either device.

B1, B2 and B3 are ``torch.library`` custom ops
(``paddle_tpu_torch::flash_fwd``, ``::flash_bwd_dq``, ``::flash_bwd_dkv``;
:func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`), B2 and
B3 registered as B1's backward, so a ``torch.compile`` region
(``jit.to_static``) calls the same kernels as the eager path and never
traces into them. A CUDA tensor goes to the kernels or raises: B1 forward
(``csrc/flash_attention.cu``), B2 dQ and B3 dK/dV
(``csrc/flash_attention_bwd.cu``), each in two variants chosen by
:func:`fwd_variant` and :func:`bwd_variant`: the tensor-core kernels for
bf16 and fp16 at head_dim 64 and 128, the scalar fp32 kernels for fp32
and the other head dims. A CPU tensor runs :func:`flash_attention_plain`
and :func:`flash_attention_bwd_plain`.

The tensor-core forward rounds the softmax weights to q's dtype before
``P V`` (the reference dots in fp32; ROADMAP C15): its lse stays within
1e-5 (relative) of the plain version on the same inputs, and each output
element within ``ulp(ref) + u max|V| + 1e-5`` of the fp32 plain version
rounded to the dtype, ``u`` the dtype's unit roundoff (2^-8 for bf16,
2^-11 for fp16). The tensor-core backward rounds p before ``P^T dO`` and
ds before ``dS K`` and ``dS^T Q`` (ROADMAP C17): each gradient element
stays within ``ulp(ref) + u (|P|^T |dO|, |dS| |K|, |dS|^T |Q|) + 1e-5
max|ref|`` of the fp32 plain version rounded to the dtype (plus, in fp16,
half a subnormal spacing for each rounded value below the normal range).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from . import _build

#: the reference's finite mask (``flash_attention.py:43``)
NEG_INF = -1e30

#: the reference's default block sizes (``flash_attention.py:50-51``)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

#: head widths the CUDA kernels take
KERNEL_HEAD_DIMS = (64, 128, 192, 256)
#: head widths of the tensor-core variant (bf16 and fp16)
WGMMA_HEAD_DIMS = (64, 128)
_FWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _cdiv(a, b):
    return (a + b - 1) // b


def fwd_variant(dtype, head_dim):
    """Which B1 kernel a CUDA call takes: ``"wgmma"`` (tensor cores) for
    bf16 and fp16 at head_dim 64 and 128, ``"simt"`` (scalar fp32) for
    fp32, which keeps the reference's fp32 parity, and for the other
    head dims. Raises for a dtype or head_dim neither kernel takes."""
    if dtype not in _FWD_DTYPES:
        raise TypeError(f"flash attention takes {list(_FWD_DTYPES)}, got "
                        f"{dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {KERNEL_HEAD_DIMS}")
    if dtype != torch.float32 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def bwd_variant(dtype, head_dim):
    """Which B2 and B3 kernels a CUDA call takes, by the same rule as
    :func:`fwd_variant`: ``"wgmma"`` (tensor cores) for bf16 and fp16 at
    head_dim 64 and 128, ``"simt"`` (scalar fp32) for fp32 and the other
    head dims. Raises for a dtype or head_dim neither kernel takes."""
    return fwd_variant(dtype, head_dim)


def tma_operand(t):
    """``t`` itself if the tensor-core kernel's TMA can read it in place:
    a 16-byte-aligned base, unit stride on head_dim and positive strides
    of a multiple of 16 bytes on every other axis longer than 1 (so
    aligned ``[b, s, h, d]`` views of a fused projection pass, and a
    broadcast view, stride 0, does not). Otherwise a contiguous copy,
    which is always aligned."""
    el, shape, stride = t.element_size(), t.shape, t.stride()
    ok = t.data_ptr() % 16 == 0 and stride[3] == 1
    for i in range(3):
        ok = ok and (shape[i] == 1
                     or (stride[i] > 0 and stride[i] * el % 16 == 0))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


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


def _bwd_setup(q, k, v, dout, lse, delta):
    """The reference backward's operands (``_bwd``, ``:343-359``) in fp32,
    padded to whole reference tiles: padded query rows get ``lse =
    +inf`` (so ``p = exp(s - inf) = 0``) and zero delta, padded keys are
    zero. Query-side tensors come back as ``[b, hk, g * sq_pad, .]``,
    grouped under their kv head."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    bq, bk = ref_blocks(sq, sk)
    sq_pad, sk_pad = _cdiv(sq, bq) * bq, _cdiv(sk, bk) * bk
    dev = q.device

    def pad_rows(x, n, fill=0.0):
        out = torch.full((*x.shape[:2], n, *x.shape[3:]), fill, device=dev)
        out[:, :, :x.shape[2]] = x.float()
        return out

    qg = pad_rows(q, sq_pad).view(b, hk, g * sq_pad, d)
    dog = pad_rows(dout, sq_pad).view(b, hk, g * sq_pad, d)
    lse_p = pad_rows(lse, sq_pad, math.inf).view(b, hk, g * sq_pad, 1)
    delta_p = pad_rows(delta, sq_pad).view(b, hk, g * sq_pad, 1)
    return (qg, pad_rows(k, sk_pad), pad_rows(v, sk_pad), dog, lse_p,
            delta_p, (g, bq, bk, sq_pad, sk_pad))


def _bwd_tile(qg, kf, vf, dog, lse_p, delta_p, tiling, j, sk, causal,
              sm_scale, q_offset, kv_offset):
    """One kv tile of the reference's recurrences (``:256-268``,
    ``:302-316``) for every query row at once: ``(p, ds)``, each ``[b,
    hk, g * sq_pad, bk]``, and the tile's K and V."""
    g, bq, bk, sq_pad, _ = tiling
    dev = qg.device
    kj, vj = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
    s = (qg @ kj.transpose(-1, -2)) * sm_scale
    k_local = j * bk + torch.arange(bk, device=dev)[None, :]
    mask = (k_local < sk).expand(sq_pad, bk)
    if causal:
        q_ids = (q_offset + torch.arange(sq_pad, device=dev))[:, None]
        mask = mask & (q_ids >= kv_offset + k_local)
    p = torch.where(mask.repeat(g, 1), torch.exp(s - lse_p), 0.0)
    dp = dog @ vj.transpose(-1, -2)
    ds = p * (dp - delta_p) * sm_scale
    return p, ds, kj, vj


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal=True,
                       sm_scale=None, q_offset=0, kv_offset=0):
    """dQ as the reference's ``_bwd_dq_kernel`` computes it (``:232-274``),
    kernel layout: for every query row, ``dq += ds K`` over the kv tiles
    in order. ``delta`` is fp32 ``[b, hq, sq]`` (see :func:`bwd_delta`).
    Returns dq in q's dtype."""
    b, hq, sq, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg, kf, vf, dog, lse_p, delta_p, tiling = _bwd_setup(q, k, v, dout, lse,
                                                         delta)
    acc = torch.zeros_like(qg)
    for j in range(tiling[4] // tiling[2]):
        _, ds, kj, _ = _bwd_tile(qg, kf, vf, dog, lse_p, delta_p, tiling, j,
                                 k.shape[2], causal, sm_scale, q_offset,
                                 kv_offset)
        acc = acc + ds @ kj
    return acc.view(b, hq, -1, d)[:, :, :sq].to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal=True,
                        sm_scale=None, q_offset=0, kv_offset=0):
    """dK and dV as the reference computes them (``_bwd_dkv_kernel``,
    ``:277-323``, then ``:410-418``), kernel layout: per query head and kv
    tile, ``dv += p^T dO`` and ``dk += ds^T Q`` in fp32, then summed over
    the GQA group and cast to k's and v's dtypes."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg, kf, vf, dog, lse_p, delta_p, tiling = _bwd_setup(q, k, v, dout, lse,
                                                         delta)
    g, sq_pad = tiling[0], tiling[3]
    # per query head: [b, hk, g, rows, .]
    qh, doh = (x.view(b, hk, g, sq_pad, d) for x in (qg, dog))
    dks, dvs = [], []
    for j in range(tiling[4] // tiling[2]):
        p, ds, _, _ = _bwd_tile(qg, kf, vf, dog, lse_p, delta_p, tiling, j,
                                sk, causal, sm_scale, q_offset, kv_offset)
        p, ds = (x.view(b, hk, g, sq_pad, -1) for x in (p, ds))
        dvs.append((p.transpose(-1, -2) @ doh).sum(2))
        dks.append((ds.transpose(-1, -2) @ qh).sum(2))
    dk = torch.cat(dks, dim=2)[:, :, :sk].to(k.dtype)
    dv = torch.cat(dvs, dim=2)[:, :, :sk].to(v.dtype)
    return dk, dv


def bwd_delta(out, dout, g_lse=None, kernel_layout=True):
    """``delta = rowsum(dO * O)`` in fp32, ``[b, h, sq]``, minus the lse
    cotangent when lse is differentiated (``_bwd``, ``:337-341``: dlse/ds
    is p, so it folds into ``ds = p (dp - delta)``). Plain torch on both
    devices, as the reference computes it in XLA outside the kernels."""
    delta = (dout.float() * out.float()).sum(-1)
    if not kernel_layout:
        delta = delta.transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, g_lse=None,
                              causal=True, sm_scale=None, q_offset=0,
                              kv_offset=0):
    """The reference's flash backward (``_bwd``, ``:326-418``) in
    PyTorch, kernel layout ``[b, h, s, d]``: ``(dq, dk, dv)`` in the
    inputs' dtypes. ``g_lse`` is the lse cotangent or None."""
    delta = bwd_delta(out, dout, g_lse)
    args = (q, k, v, dout, lse, delta, causal, sm_scale, q_offset,
            kv_offset)
    return (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))


def _check_qkv(q, k, v, seq_dim):
    """Shapes ``(b, hq, hk, sq, sk, d)`` of q, k, v whose sequence axis
    is ``seq_dim``; raises on what the kernels do not take."""
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
    return b, hq, hk, sq, sk, d


def _unit_last(*ts):
    """The kernels read head_dim with unit stride; copy what has not."""
    return [t if t.stride(3) == 1 else t.contiguous() for t in ts]


def _strides(ts, seq_dim):
    """Element strides (batch, head, row) of each tensor, in order."""
    out = []
    for t in ts:
        st = t.stride()
        out += [st[0], st[3 - seq_dim], st[seq_dim]]
    return out


def _flash_cuda(q, k, v, causal, sm_scale, q_offset, kv_offset, seq_dim):
    """Launch B1 on tensors whose sequence axis is ``seq_dim`` (2 in
    kernel layout, 1 in the public one): the variant of
    :func:`fwd_variant`, its operands passed in place where it can read
    them (:func:`tma_operand` for the tensor-core kernel; head_dim
    contiguous for the scalar one) and copied otherwise. Returns ``(out,
    lse)``, out in q's layout."""
    code = _build.dtype_code(q.dtype)
    b, hq, hk, sq, sk, d = _check_qkv(q, k, v, seq_dim)
    wgmma = fwd_variant(q.dtype, d) == "wgmma"
    q, k, v = ([tma_operand(t) for t in (q, k, v)] if wgmma
               else _unit_last(q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    bq, bk = ref_blocks(sq, sk)
    # plain Python numbers: the exported function's argtypes convert them
    args = (code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_strides((q, k, v, out), seq_dim), b, hq, hk,
            sq, sk, d, int(q_offset), int(kv_offset), int(bool(causal)), bq,
            bk, float(sm_scale))
    _build.launch("ptt_flash_fwd_wgmma" if wgmma else "ptt_flash_fwd",
                  q.device, args, _counters(flash_attention, wgmma, shape_key(
                      q.dtype, d, hq, hk, causal)))
    return out, lse


def shape_key(dtype, d, hq, hk, causal):
    """The key of a wrapper's ``launches_by_shape``: dtype, head_dim, the
    GQA group and the mask, as ``"bfloat16 d128 g1 causal"``."""
    return (f"{str(dtype).replace('torch.', '')} d{d} g{hq // hk} "
            f"{'causal' if causal else 'full'}")


def _counters(fn, wgmma, key):
    """The launch counters of wrapper ``fn`` that a launch adds one to:
    every launch, the tensor-core ones, and its ``launches_by_shape``
    entry ``key`` (:func:`shape_key`)."""
    return ((fn, "launches"), (fn.launches_by_shape, key)) + (
        ((fn, "wgmma_launches"),) if wgmma else ())


def _bwd_operands(q, k, v, dout, lse, delta, seq_dim):
    """Checked operands of B2 or B3 and the variant they take: q, k, v and
    dout passed in place where the kernel can read them
    (:func:`tma_operand` for the tensor-core kernels; head_dim contiguous
    for the scalar ones) and copied otherwise; lse and delta contiguous
    fp32."""
    b, hq, hk, sq, sk, d = _check_qkv(q, k, v, seq_dim)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"fit q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {(b, hq, sq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    wgmma = bwd_variant(q.dtype, d) == "wgmma"
    q, k, v, dout = ([tma_operand(t) for t in (q, k, v, dout)] if wgmma
                     else _unit_last(q, k, v, dout))
    return (q, k, v, dout, lse.contiguous(), delta.contiguous(),
            (b, hq, hk, sq, sk, d), wgmma)


def _dims_key(q, dims, causal):
    """:func:`shape_key` of a backward launch over ``dims`` (b, hq, hk,
    sq, sk, d)."""
    _, hq, hk, _, _, d = dims
    return shape_key(q.dtype, d, hq, hk, causal)


def _bwd_ints(dims, q_offset, kv_offset, causal, sm_scale):
    return ([ctypes.c_int(int(x)) for x in (*dims, q_offset, kv_offset,
                                            bool(causal))]
            + [ctypes.c_float(sm_scale)])


def _to_kernel(kernel_layout, *ts):
    return ts if kernel_layout else tuple(t.transpose(1, 2) for t in ts)


def _from_kernel(kernel_layout, *ts):
    """Outputs of the plain versions (kernel layout) in the caller's
    layout, contiguous as the CUDA kernels write them."""
    return tuple((t if kernel_layout else t.transpose(1, 2)).contiguous()
                 for t in ts)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


# -- B1, B2 and B3 as torch.library custom ops ---------------------------------
#
# Each op's CUDA implementation launches the hand-written kernel (and raises
# where it cannot); its CPU implementation is the plain version. A compiled
# region (``torch.compile``, ``jit.to_static``) keeps them opaque: the fake
# implementations give the shapes, and B2 + B3 are B1's registered backward,
# so eager and compiled paths launch the same kernels and count the same
# launches, at run time. The schemas come from the signatures, defaults
# included; ``sm_scale=None`` is ``1 / sqrt(head_dim)``. The dispatcher may
# drop trailing arguments equal to their defaults, so every implementation
# repeats them.


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
              sm_scale: Optional[float] = None, q_offset: int = 0,
              kv_offset: int = 0, kernel_layout: bool = True
              ) -> Tuple[Tensor, Tensor]:
    """B1: ``(out, lse)``, out in q's layout and dtype, lse fp32 ``[b, hq,
    sq]``. q, k and v in kernel layout ``[b, h, s, d]`` or, with
    ``kernel_layout=False``, ``[b, s, h, d]`` (strided views allowed).
    The CPU implementation is :func:`flash_attention_plain`."""
    out, lse = flash_attention_plain(*_to_kernel(kernel_layout, q, k, v),
                                     causal, _scale(q, sm_scale), q_offset,
                                     kv_offset)
    return _from_kernel(kernel_layout, out)[0], lse.contiguous()


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal=True, sm_scale=None, q_offset=0,
                    kv_offset=0, kernel_layout=True):
    return _flash_cuda(q, k, v, causal, _scale(q, sm_scale), q_offset,
                       kv_offset, 2 if kernel_layout else 1)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal=True, sm_scale=None, q_offset=0,
                    kv_offset=0, kernel_layout=True):
    seq_dim = 2 if kernel_layout else 1
    b, sq, hq = q.shape[0], q.shape[seq_dim], q.shape[3 - seq_dim]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return out, q.new_empty((b, hq, sq), dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dq", mutates_args=(),
                         device_types="cpu")
def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
                 delta: Tensor, causal: bool = True,
                 sm_scale: Optional[float] = None, q_offset: int = 0,
                 kv_offset: int = 0, kernel_layout: bool = True) -> Tensor:
    """B2: dq in q's layout and dtype (the variant of :func:`bwd_variant`,
    counted in ``flash_bwd_dq.launches`` and the tensor-core ones also in
    ``flash_bwd_dq.wgmma_launches``). q, k, v and dout as :func:`flash_fwd`
    takes them; lse and delta fp32 ``[b, hq, sq]``. The CPU
    implementation is :func:`flash_bwd_dq_plain`."""
    q, k, v, dout = _to_kernel(kernel_layout, q, k, v, dout)
    return _from_kernel(kernel_layout, flash_bwd_dq_plain(
        q, k, v, dout, lse, delta, causal, _scale(q, sm_scale), q_offset,
        kv_offset))[0]


@flash_bwd_dq.register_kernel("cuda")
def _flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal=True,
                       sm_scale=None, q_offset=0, kv_offset=0,
                       kernel_layout=True):
    seq_dim = 2 if kernel_layout else 1
    sm_scale = _scale(q, sm_scale)
    q, k, v, dout, lse, delta, dims, wgmma = _bwd_operands(
        q, k, v, dout, lse, delta, seq_dim)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    args = ([ctypes.c_int(_build.dtype_code(q.dtype))]
            + [ctypes.c_void_p(t.data_ptr())
               for t in (q, k, v, dout, lse, delta, dq)]
            + _strides((q, k, v, dout, dq), seq_dim)
            + _bwd_ints(dims, q_offset, kv_offset, causal, sm_scale))
    _build.launch("ptt_flash_bwd_dq_wgmma" if wgmma else "ptt_flash_bwd_dq",
                  q.device, args, _counters(flash_bwd_dq, wgmma,
                                            _dims_key(q, dims, causal)))
    return dq


@flash_bwd_dq.register_fake
def _flash_bwd_dq_fake(q, k, v, dout, lse, delta, *args, **kwargs):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


flash_bwd_dq.launches = 0
flash_bwd_dq.wgmma_launches = 0
flash_bwd_dq.launches_by_shape = {}


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dkv", mutates_args=(),
                         device_types="cpu")
def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, dout: Tensor,
                  lse: Tensor, delta: Tensor, causal: bool = True,
                  sm_scale: Optional[float] = None, q_offset: int = 0,
                  kv_offset: int = 0, kernel_layout: bool = True
                  ) -> Tuple[Tensor, Tensor]:
    """B3: ``(dk, dv)`` in k's layout and dtype, summed over each kv
    head's query group (counted in ``flash_bwd_dkv.launches`` and
    ``.wgmma_launches``). Arguments as :func:`flash_bwd_dq`. The CPU
    implementation is :func:`flash_bwd_dkv_plain`."""
    q, k, v, dout = _to_kernel(kernel_layout, q, k, v, dout)
    return _from_kernel(kernel_layout, *flash_bwd_dkv_plain(
        q, k, v, dout, lse, delta, causal, _scale(q, sm_scale), q_offset,
        kv_offset))


@flash_bwd_dkv.register_kernel("cuda")
def _flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal=True,
                        sm_scale=None, q_offset=0, kv_offset=0,
                        kernel_layout=True):
    seq_dim = 2 if kernel_layout else 1
    sm_scale = _scale(q, sm_scale)
    q, k, v, dout, lse, delta, dims, wgmma = _bwd_operands(
        q, k, v, dout, lse, delta, seq_dim)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    args = ([ctypes.c_int(_build.dtype_code(q.dtype))]
            + [ctypes.c_void_p(t.data_ptr())
               for t in (q, k, v, dout, lse, delta, dk, dv)]
            + _strides((q, k, v, dout, dk, dv), seq_dim)
            + _bwd_ints(dims, q_offset, kv_offset, causal, sm_scale))
    _build.launch("ptt_flash_bwd_dkv_wgmma" if wgmma else "ptt_flash_bwd_dkv",
                  q.device, args, _counters(flash_bwd_dkv, wgmma,
                                            _dims_key(q, dims, causal)))
    return dk, dv


@flash_bwd_dkv.register_fake
def _flash_bwd_dkv_fake(q, k, v, dout, lse, delta, *args, **kwargs):
    return (torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


flash_bwd_dkv.launches = 0
flash_bwd_dkv.wgmma_launches = 0
flash_bwd_dkv.launches_by_shape = {}


def flash_attention_bwd(q, k, v, out, lse, dout, g_lse=None, causal=True,
                        sm_scale=None, q_offset=0, kv_offset=0,
                        kernel_layout=True):
    """The flash backward on either device: delta in plain torch, then
    :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`. Returns ``(dq, dk,
    dv)`` in the inputs' layout."""
    delta = bwd_delta(out, dout, g_lse, kernel_layout)
    args = (q, k, v, dout, lse, delta, causal, sm_scale, q_offset,
            kv_offset, kernel_layout)
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale, q_offset, kv_offset, kernel_layout = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.args = (causal, sm_scale, q_offset, kv_offset, kernel_layout)


def _flash_fwd_backward(ctx, dout, g_lse):
    """B1's backward (the reference's ``_flash`` and ``_flash_with_lse``
    custom VJPs, ``:425-460``): B2 and B3 on the saved q, k, v, out and
    lse; both outputs are differentiable."""
    q, k, v, out, lse = ctx.saved_tensors
    if dout is None:
        dout = torch.zeros_like(out)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, g_lse,
                                     *ctx.args)
    return dq, dk, dv, None, None, None, None, None


flash_fwd.register_autograd(_flash_fwd_backward,
                            setup_context=_flash_fwd_setup)


def flash_attention(q, k, v, causal=True, sm_scale=None, q_offset=0,
                    kv_offset=0, kernel_layout=False):
    """Flash attention. Layout ``[b, s, h, d]``, or ``[b, h, s, d]`` with
    ``kernel_layout=True``; the output comes back in the input's layout.
    Differentiable in q, k and v. CUDA launches are counted in
    ``flash_attention.launches`` (B1, both variants; the tensor-core ones
    also in ``flash_attention.wgmma_launches``), ``flash_bwd_dq.launches``
    (B2) and ``flash_bwd_dkv.launches`` (B3), each with its own
    ``wgmma_launches`` and ``launches_by_shape`` (:func:`shape_key`)."""
    return flash_fwd(q, k, v, causal, sm_scale, q_offset, kv_offset,
                     kernel_layout)[0]


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.launches_by_shape = {}


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             q_offset=0, kv_offset=0):
    """Kernel-layout ``[b, h, s, d]`` flash attention returning ``(out,
    lse)``, lse fp32 ``[b, h, sq]`` (``NEG_INF`` for a row whose visited
    keys all carry no weight). Differentiable through both outputs."""
    return flash_fwd(q, k, v, causal, sm_scale, q_offset, kv_offset, True)
