"""Ragged paged attention: one call for a tick's mixed prefill and decode
tokens over the shared paged KV pool (port of
``paddle_tpu/ops/pallas/ragged_paged_attention.py``).

The serving scheduler packs a tick's work into one flat token batch and
describes each sequence by ``(slot, q_start, q_len, context_len)``:

* ``slot``         row of ``block_tables`` (the sequence's page map);
* ``q_start``      offset of the sequence's first token in the flat
                   ``q`` batch (non-decreasing across sequences);
* ``q_len``        new tokens this step (1 for decode);
* ``context_len``  total context including the new tokens, so query ``j``
                   of the span attends positions
                   ``[0, context_len - q_len + j]``.

Tokens outside every span are bucket padding; their output is garbage
and the caller discards it.

Pages are native (the query's dtype, or fp32 under a bf16 or fp16
query, as a 16-bit model's pools are under AMP's O2) or int8 with one
fp32 scale per ``(kv head, page, slot)`` row (``k_scales``/
``v_scales``), each row dequantised in fp32 as ``int8 * scale`` before
both dots. The output takes the query's dtype; over fp32 pages a 16-bit
query gives the fp32 query's result, rounded once.

Two grids compute the same function, each a kernel written for Hopper
(``csrc/qblock.cuh`` for the q-block grid, ``csrc/ragged_paged_attention
.cu`` for the per-token one) for native pages and another for int8
pages:

* **q-block** (default; kernel 6, B7 on int8 pages): the reference tiles
  the batch into q-blocks and walks, per (q-block, kv head), a host-built
  job list, one (page, owner slot, kv offset) per KV page any sequence in
  the block needs. Rows of a block may belong to different sequences;
  keys of another owner's job are masked with the finite ``BIG_NEG`` so
  such jobs are exact no-ops (see ``BIG_NEG``). The kernel therefore runs
  one thread block per work unit (q-block, owner slot) and kv head over
  that owner's pages alone (:func:`qblock_units`); the plain version
  keeps the reference's job walk. Two variants on the same units and
  grid, chosen by :func:`qblock_variant` before the launch: ``"unit"``
  (pages of 4, 8, 16 or 32 keys, head_dim % 16 == 0, 16-byte aligned
  pools, a block that fits shared memory)
  stages pages by asynchronous copies and spreads a row's recurrence over
  threads; ``"runtime"`` takes the page size as an argument and every
  other shape, staging pages by plain loads.
* **token** (kernel 8, B9 on int8 pages): each (token, kv head) walks
  that token's own pages through its block-table row. Two variants,
  chosen by :func:`token_variant` before the launch: ``"cluster"`` splits
  the walk across a thread-block cluster of :func:`token_splits` blocks,
  which exchange page maxima and fold every page's partial terms in page
  order (:func:`token_split_model` is its algorithm in PyTorch, for the
  tests); ``"block"`` runs one block per (token, kv head) over the whole
  context, for the shapes the first cannot take.

Both grids give a real token's row the same bits (ROADMAP C21): the same
per-row arithmetic over the row's own pages in the same order.

A CUDA tensor goes to the kernel or raises. A CPU tensor runs the plain
PyTorch version of the same recurrence, which is also what the kernels
are held against on the card.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .paged_attention import SMEM_LIMIT, _sm_count, launch_counters

#: causal mask inside a row's own pages (``paged_attention.py:52``)
NEG_INF = float("-inf")

#: finite mask for keys of another sequence's job. A row whose first
#: visited job is alien would otherwise reach m = -inf and then
#: exp(-inf - -inf) = NaN. With -1e30 the first own-slot job's rescale
#: factor exp(-1e30 - m_real) underflows to exactly 0.0, erasing the
#: alien garbage bitwise; alien jobs after it are exact no-ops (weights
#: exp(-1e30 - m_real) = 0.0, correction exp(0) = 1.0).
BIG_NEG = -1e30

#: tokens per q-block
DEFAULT_QBLOCK = 8

IMPLS = ("qblock", "token")

#: the q-block kernels' variants (see :func:`qblock_variant`)
QBLOCK_VARIANTS = ("unit", "runtime")
#: the page sizes the ``"unit"`` kernel is built for (one source each;
#: its lane scheme takes powers of two up to 32, and bulk copies of int8
#: row scales need pages of at least 4)
UNIT_PAGE_SIZES = _build.UNIT_PAGES
#: the ``"unit"`` kernel's pages a staged chunk and its K rows' padding in
#: bytes (``kChunk``, ``staged_row`` in ``csrc/qblock.cuh``)
UNIT_CHUNK, UNIT_ROW_PAD = 4, 16

#: the per-token kernels' variants (see :func:`token_variant`)
TOKEN_VARIANTS = ("cluster", "block")
#: the page size the ``"cluster"`` kernel takes, the most blocks a (token,
#: kv head) splits over (the portable cluster size) and the most pages a
#: block may take a round (``token_split_kernel``'s limit)
SPLIT_PAGE, MAX_SPLITS, MAX_ROUND_PAGES = 16, 8, 8
#: the pages c a block takes a round in a cluster, and alone (one split:
#: the block is one of many on its SM, and fewer, larger rounds cut the
#: serial latency of a (token, kv head))
ROUND_PAGES, ROUND_PAGES_ALONE = 4, 6
#: the blocks an SM that :func:`token_splits` aims the grid at
SPLIT_BLOCKS_PER_SM = 2


def token_round_pages(splits):
    """The pages c each of ``splits`` blocks takes a round."""
    return ROUND_PAGES_ALONE if splits == 1 else ROUND_PAGES


def _token_descriptors(num_tokens, seq_slots, q_starts, q_lens,
                       context_lens):
    """Expand per-sequence descriptors into per-token ``tok_slot[t]``
    (block-table row) and ``tok_ctx[t]`` (key positions visible to token
    ``t``). Padding tokens get ``(slot 0, ctx 1)``: one finite, discarded
    garbage score instead of an all-masked NaN softmax. numpy int32."""
    ss = np.asarray(seq_slots, np.int32).reshape(-1)
    qs = np.asarray(q_starts, np.int32).reshape(-1)
    ql = np.asarray(q_lens, np.int32).reshape(-1)
    cl = np.asarray(context_lens, np.int32).reshape(-1)
    tok = np.arange(int(num_tokens), dtype=np.int32)
    if qs.size == 0:                   # a tick of padding alone
        return np.zeros_like(tok), np.ones_like(tok)
    seq_of = np.clip(
        np.searchsorted(qs, tok, side="right").astype(np.int32) - 1,
        0, max(qs.shape[0] - 1, 0))
    off = tok - qs[seq_of]
    valid = (off >= 0) & (off < ql[seq_of])
    tok_slot = np.where(valid, ss[seq_of], 0).astype(np.int32)
    tok_ctx = np.where(valid, cl[seq_of] - ql[seq_of] + off + 1,
                       1).astype(np.int32)
    return tok_slot, tok_ctx


def qblock_schedule(num_tokens, seq_slots, q_starts, q_lens, context_lens,
                    block_tables, q_block, page_size, num_jobs=None):
    """Host-side schedule for the q-block grid.

    Tiles the flat batch into fixed ``q_block``-row blocks and lists, per
    block, its jobs: one (physical page, owner slot, kv offset) triple
    per KV page any sequence in the block still needs. Pages of one slot
    ascend, slots come in first-appearance order, so each row sees its
    own pages in the per-token kernel's order. The job count is padded
    to a power of two, or to ``num_jobs`` when given (a fixed width, see
    :func:`qblock_caps`; a schedule that needs more raises).

    Sentinels: rows past ``num_tokens`` (block padding) get slot -1 /
    ctx 0; padding jobs get slot -2 / page 0. They never match each
    other, so every row's scores keep at least one finite entry.

    Returns ``(row_slot [B*q_block], row_ctx [B*q_block],
    job_page [B, J], job_slot [B, J], job_kv [B, J])`` int32 numpy.
    """
    tbl = np.asarray(block_tables, np.int32)
    pages_per_seq = tbl.shape[1]
    T = int(num_tokens)
    q_block = max(int(q_block), 1)
    ts, tc = _token_descriptors(T, seq_slots, q_starts, q_lens,
                                context_lens)

    nblocks = -(-T // q_block)
    t_pad = nblocks * q_block
    row_slot = np.full(t_pad, -1, np.int32)
    row_ctx = np.zeros(t_pad, np.int32)
    row_slot[:T] = ts
    row_ctx[:T] = tc
    bs = row_slot.reshape(nblocks, q_block)
    bc = row_ctx.reshape(nblocks, q_block)

    jobs = []
    max_jobs = 1
    for b in range(nblocks):
        block_jobs = []
        seen = []
        for r in range(q_block):
            slot = int(bs[b, r])
            if slot < 0 or slot in seen:
                continue
            seen.append(slot)
            cmax = int(bc[b][bs[b] == slot].max())
            n_pages = min(max(-(-cmax // page_size), 1), pages_per_seq)
            for p in range(n_pages):
                block_jobs.append((int(tbl[slot, p]), slot, p * page_size))
        if not block_jobs:
            block_jobs.append((0, -2, 0))
        jobs.append(block_jobs)
        max_jobs = max(max_jobs, len(block_jobs))

    if num_jobs is None:
        num_jobs = 1 << (max_jobs - 1).bit_length()
    elif max_jobs > num_jobs:
        raise ValueError(f"a q-block needs {max_jobs} jobs, more than the "
                         f"fixed width {num_jobs}")
    job_page = np.zeros((nblocks, num_jobs), np.int32)
    job_slot = np.full((nblocks, num_jobs), -2, np.int32)
    job_kv = np.zeros((nblocks, num_jobs), np.int32)
    for b, block_jobs in enumerate(jobs):
        for j, (page, slot, kv) in enumerate(block_jobs):
            job_page[b, j] = page
            job_slot[b, j] = slot
            job_kv[b, j] = kv
    return row_slot, row_ctx, job_page, job_slot, job_kv


def qblock_units(job_slot):
    """The q-block kernel's work units from a schedule's ``job_slot [B,
    J]``: one ``(block b, owner slot s, first job j0, job count n)`` per
    run of equal slots >= 0 in a block's job list, in block and list
    order. The schedule lists each slot's pages as one ascending run, so a
    unit's pages are ``job_page[b, j0:j0 + n]``, pages 0..n-1 of slot
    ``s``, and its rows are the rows of block ``b`` whose ``row_slot`` is
    ``s``. Padding jobs (slot -2) get no unit. Returns int32 ``[U, 4]``."""
    js = np.asarray(job_slot, np.int32)
    edge = np.full((js.shape[0], 1), -3, np.int32)
    before = np.concatenate([edge, js[:, :-1]], axis=1)
    after = np.concatenate([js[:, 1:], edge], axis=1)
    b, j0 = np.nonzero((js >= 0) & (js != before))
    _, j1 = np.nonzero((js >= 0) & (js != after))      # same row order
    return np.stack([b, js[b, j0], j0, j1 - j0 + 1], axis=1).astype(
        np.int32).reshape(-1, 4)


def qblock_caps(num_tokens, q_block, max_slots, pages_per_seq):
    """The fixed q-block grid of a ``num_tokens`` bucket whose sequences
    come from at most ``max_slots`` slots of ``pages_per_seq`` pages:
    ``(U_max, J_max)``. A block of ``q_block`` rows holds at most
    ``min(q_block, max_slots)`` slots, each a unit of at most
    ``pages_per_seq`` jobs, so ``J_max = min(q_block, max_slots) *
    pages_per_seq``. A block's units are one plus the changes of slot
    inside it; rows packed as the engines pack them (spans back to back
    from row 0, then padding, which reads slot 0) change slot at most
    once a span, and a tick holds at most ``max_slots`` spans, so with
    ``B = ceil(num_tokens / q_block)`` blocks ``U_max = min(B *
    min(q_block, max_slots), B + max_slots)`` (:func:`plan_arrays`
    raises for a layout that needs more).
    Shapes alone decide both: a tick of that bucket launches the same
    grid whatever its spans (a CUDA graph replays it)."""
    per_block = min(max(int(q_block), 1), int(max_slots))
    blocks = -(-int(num_tokens) // max(int(q_block), 1))
    return (min(blocks * per_block, blocks + int(max_slots)),
            per_block * int(pages_per_seq))


def plan_arrays(num_tokens, seq_slots, q_starts, q_lens, context_lens,
                block_tables, page_size, *, impl="qblock",
                q_block=DEFAULT_QBLOCK, max_slots=None):
    """The host arrays (int32 numpy, by name) of ``impl``'s schedule.

    q-block: ``row_slot``, ``row_ctx``, ``job_page``, ``job_slot``,
    ``job_kv``, ``units`` and ``n_units`` (the live unit count, which the
    kernel reads on the device: a block at or past it returns at once).
    With ``max_slots`` the grid is the fixed one of :func:`qblock_caps`:
    the job lists are padded to ``J_max`` with padding jobs (slot -2,
    which get no unit) and ``units`` to ``U_max`` rows of zeros past the
    live ones. Per-token: ``tok_slot``, ``tok_ctx`` and ``tables``, whose
    shapes already depend on ``num_tokens`` and the table alone."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    tbl = np.ascontiguousarray(np.asarray(block_tables, np.int32))
    if impl == "token":
        names = ("tok_slot", "tok_ctx", "tables")
        arrays = _token_descriptors(num_tokens, seq_slots, q_starts,
                                    q_lens, context_lens) + (tbl,)
        return {n: np.ascontiguousarray(a) for n, a in zip(names, arrays)}
    caps = (None if max_slots is None
            else qblock_caps(num_tokens, q_block, max_slots, tbl.shape[1]))
    arrays = qblock_schedule(num_tokens, seq_slots, q_starts, q_lens,
                             context_lens, tbl, q_block, page_size,
                             num_jobs=None if caps is None else caps[1])
    units = qblock_units(arrays[3])
    live = units.shape[0]
    if caps is not None and live > caps[0]:
        raise ValueError(f"{live} q-block units, more than the fixed grid's "
                         f"{caps[0]}: the spans come from more than "
                         f"{max_slots} slots")
    if caps is not None:
        units = np.concatenate([units, np.zeros((caps[0] - live, 4),
                                                np.int32)])
    names = ("row_slot", "row_ctx", "job_page", "job_slot", "job_kv",
             "units", "n_units")
    arrays += (units, np.asarray([live], np.int32))
    return {n: np.ascontiguousarray(a) for n, a in zip(names, arrays)}


@dataclass
class RaggedPlan:
    """What one ragged call needs besides q and the pages: the schedule
    of its grid as int32 tensors on the device, plus the host copies the
    plain versions loop over. Built once per forward and shared by every
    layer (the descriptors and block tables do not change between
    layers). ``pages_per_seq`` is the block table's width, the most
    pages a q-block unit walks."""
    impl: str
    num_tokens: int
    page_size: int
    q_block: int
    host: dict
    dev: dict
    pages_per_seq: int


def make_plan(num_tokens, seq_slots, q_starts, q_lens, context_lens,
              block_tables, page_size, *, impl="qblock",
              q_block=DEFAULT_QBLOCK, device="cpu", max_slots=None):
    """Build the schedule of ``impl``'s grid from host descriptors
    (:func:`plan_arrays`; ``max_slots`` gives the q-block grid its fixed
    shape) and copy it to ``device``."""
    host = plan_arrays(num_tokens, seq_slots, q_starts, q_lens,
                       context_lens, block_tables, page_size, impl=impl,
                       q_block=q_block, max_slots=max_slots)
    dev = {n: torch.from_numpy(a).to(device) for n, a in host.items()}
    return RaggedPlan(impl, int(num_tokens), int(page_size),
                      max(int(q_block), 1), host, dev,
                      int(np.shape(block_tables)[1]))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _gather_pages(k_pages, v_pages, k_scales, v_scales, pages):
    """Pages ``pages [n]`` of every kv head as fp32 ``[n, KVH, P, D]``;
    int8 pages dequantised row by row (``int8 * scale`` in fp32, the
    reference's ``:280-281``)."""
    k, v = k_pages[:, pages].float(), v_pages[:, pages].float()
    if k_scales is not None:
        k = k * k_scales[:, pages][..., None]
        v = v * v_scales[:, pages][..., None]
    return k.transpose(0, 1), v.transpose(0, 1)


def _online_step(s, v, m, l, acc):
    """One online-softmax step over a page of scores ``s [..., R, P]``
    against values ``v [..., P, D]``; returns the new (m, l, acc)."""
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    w = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + w.sum(-1, keepdim=True)
    acc = acc * corr + w @ v
    return m_new, l, acc


def qblock_attention_plain(q, k_pages, v_pages, plan, sm_scale,
                           k_scales=None, v_scales=None):
    """The q-block kernel's recurrence in PyTorch: every block and kv head
    at once, one job column at a time, exactly the JAX grid's order. It
    stops after the last column that holds a real job in some block: a
    column of padding jobs alone leaves every real row's state unchanged
    bit for bit (see ``BIG_NEG``), so a plan padded to a fixed job width
    costs no more. With ``k_scales``/``v_scales`` the pages are int8
    codes."""
    T, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    qb = plan.q_block
    d = plan.dev
    B = d["job_page"].shape[0]
    real = np.flatnonzero((plan.host["job_slot"] >= 0).any(axis=0))
    J = int(real[-1]) + 1 if real.size else 1
    R = qb * G
    qp = torch.zeros(B * qb, H, D, dtype=torch.float32, device=q.device)
    qp[:T] = q.float()
    qg = qp.view(B, qb, KVH, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, KVH, R, D)
    rs = d["row_slot"].view(B, qb).repeat_interleave(G, dim=1)[:, None, :,
                                                               None]
    rc = d["row_ctx"].view(B, qb).repeat_interleave(G, dim=1)[:, None, :,
                                                              None]
    m = torch.full((B, KVH, R, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, KVH, R, 1), device=q.device)
    acc = torch.zeros((B, KVH, R, D), device=q.device)
    iota = torch.arange(P, device=q.device, dtype=torch.int32)
    for j in range(J):
        jp = d["job_page"][:, j].long()
        k, v = _gather_pages(k_pages, v_pages, k_scales, v_scales,
                             jp)                         # [B, KVH, P, D]
        s = (qg @ k.transpose(-1, -2)) * sm_scale        # [B, KVH, R, P]
        pos = (d["job_kv"][:, j, None] + iota)[:, None, None, :]
        s = torch.where(pos < rc, s, NEG_INF)
        s = torch.where(rs == d["job_slot"][:, j, None, None, None], s,
                        BIG_NEG)
        m, l, acc = _online_step(s, v, m, l, acc)
    out = acc / l.clamp_min(1e-30)
    out = out.view(B, KVH, qb, G, D).permute(0, 2, 1, 3, 4).reshape(
        B * qb, H, D)
    return out[:T].to(q.dtype)


def token_attention_plain(q, k_pages, v_pages, plan, sm_scale,
                          k_scales=None, v_scales=None):
    """The per-token kernel's recurrence in PyTorch, every token at once,
    one page column at a time. It stops at the longest context's last
    page: a page past a token's context is fully masked, which leaves m,
    l and acc unchanged bit for bit (w = 0, corr = exp(0) = 1). With
    ``k_scales``/``v_scales`` the pages are int8 codes."""
    T, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    d = plan.dev
    pages_per_seq = d["tables"].shape[1]
    n_pages = min(int(-(-plan.host["tok_ctx"].max(initial=1) // P)),
                  pages_per_seq)
    qg = q.float().view(T, KVH, G, D)
    ctx = d["tok_ctx"][:, None, None, None]
    m = torch.full((T, KVH, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((T, KVH, G, 1), device=q.device)
    acc = torch.zeros((T, KVH, G, D), device=q.device)
    iota = torch.arange(P, device=q.device, dtype=torch.int32)
    rows = d["tables"][d["tok_slot"].long()]             # [T, pages]
    for p in range(n_pages):
        k, v = _gather_pages(k_pages, v_pages, k_scales, v_scales,
                             rows[:, p].long())          # [T, KVH, P, D]
        s = (qg @ k.transpose(-1, -2)) * sm_scale        # [T, KVH, G, P]
        s = torch.where(p * P + iota < ctx, s, NEG_INF)
        m, l, acc = _online_step(s, v, m, l, acc)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(T, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# the "cluster" per-token kernel: its schedule, rule and algorithm
# ---------------------------------------------------------------------------

def token_splits(num_tokens, kv_heads, pages_per_seq, n_sm):
    """The ``"cluster"`` kernel's splits S per (token, kv head): enough
    that the grid of S x kv_heads x tokens blocks gives each of the
    ``n_sm`` SMs about SPLIT_BLOCKS_PER_SM, at most MAX_SPLITS and at most
    the table's rounds of ROUND_PAGES pages a block. Shapes alone decide
    it: the contexts live on the device, and reading them would stall the
    host once a layer."""
    rounds = -(-pages_per_seq // ROUND_PAGES)
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // max(num_tokens * kv_heads, 1))
    return max(1, min(MAX_SPLITS, rounds, want))


def token_split_rounds(split, splits, n_pages, round_pages=None):
    """The pages below ``n_pages`` that block ``split`` of ``splits``
    takes, round by round: round k covers pages k S c .. (k + 1) S c - 1
    (c = ``round_pages``, :func:`token_round_pages` by default) and the
    block takes the c consecutive ones from k S c + split c. Every block
    has the same rounds; one with no page in a round gets an empty
    list."""
    c = token_round_pages(splits) if round_pages is None else round_pages
    per = splits * c
    return [list(range(k * per + split * c,
                       min(k * per + (split + 1) * c, n_pages)))
            for k in range(-(-n_pages // per))]


def round_maxima(m, parts):
    """Step (b) of a round: each page's running max before (``m_prev``)
    and after (``m_new``) it, in page order from the carried ``m``, over
    the page maxima the blocks exchange (a page past a token's context is
    skipped); returns the max carried into the next round."""
    for part in parts:
        m_new = torch.where(part["live"], torch.maximum(m, part["mcur"]), m)
        part["m_prev"], part["m_new"] = m, m_new
        m = m_new
    return m


def page_terms(part):
    """Step (c), one page where its block holds it: the weights against
    the running max after the page, their sum, ``corr`` and ``pv``."""
    w = torch.exp(part["s"] - part["m_new"])
    part.update(sum=w.sum(-1, keepdim=True),
                corr=torch.exp(part["m_prev"] - part["m_new"]),
                pv=w @ part["v"])


def ordered_fold(acc, l, parts):
    """Step (d): the round's pages folded into acc and l in page order,
    ``acc corr + pv`` and ``l corr + sum``, a page past a token's context
    skipped."""
    for part in parts:
        live = part["live"]
        l = torch.where(live, l * part["corr"] + part["sum"], l)
        acc = torch.where(live, acc * part["corr"] + part["pv"], acc)
    return acc, l


def token_split_model(q, k_pages, v_pages, plan, sm_scale, splits,
                      k_scales=None, v_scales=None, round_pages=None):
    """The ``"cluster"`` kernel's algorithm in fp32 PyTorch, for the tests
    (no main path runs it): every token at once, its pages in rounds of
    ``splits`` x c (c = ``round_pages``, :func:`token_round_pages` by
    default), each block's pages dealt by :func:`token_split_rounds`;
    per round the blocks' scores and page maxima, :func:`round_maxima`,
    :func:`page_terms` and :func:`ordered_fold`. Each step is the plain
    version's operation on the same values, so in fp32 the model gives
    :func:`token_attention_plain`'s bits (the kernel gives the q-block
    kernel's, ROADMAP C21). Same arguments as the plain version."""
    T, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    d = plan.dev
    pps = d["tables"].shape[1]
    npg = torch.from_numpy(np.minimum(-(-plan.host["tok_ctx"] // P),
                                      pps)).to(q.device)
    n_pages = int(npg.max()) if T else 0
    qg = q.float().view(T, KVH, G, D)
    ctx = d["tok_ctx"][:, None, None, None]
    m = torch.full((T, KVH, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((T, KVH, G, 1), device=q.device)
    acc = torch.zeros((T, KVH, G, D), device=q.device)
    iota = torch.arange(P, device=q.device, dtype=torch.int32)
    rows = d["tables"][d["tok_slot"].long()]             # [T, pages]
    dealt = [token_split_rounds(s, splits, n_pages, round_pages)
             for s in range(splits)]
    for k in range(len(dealt[0])):
        # (a) each block scores its pages and takes their maxima
        parts = []
        for split, rounds in enumerate(dealt):
            for p in rounds[k]:
                kk, v = _gather_pages(k_pages, v_pages, k_scales, v_scales,
                                      rows[:, p].long())  # [T, KVH, P, D]
                s = (qg @ kk.transpose(-1, -2)) * sm_scale
                s = torch.where(p * P + iota < ctx, s, NEG_INF)
                parts.append(dict(page=p, split=split, s=s, v=v,
                                  mcur=s.amax(-1, keepdim=True),
                                  live=(p < npg)[:, None, None, None]))
        parts.sort(key=lambda part: part["page"])
        # (b) the page maxima exchanged; (c) each page's terms where its
        # block holds it; (d) the ordered fold
        m = round_maxima(m, parts)
        for part in parts:
            page_terms(part)
        acc, l = ordered_fold(acc, l, parts)
    out = acc / l.clamp_min(1e-30)
    return out.reshape(T, H, D).to(q.dtype)


def unit_smem_bytes(el, quant, R, P, D, q_block, unit_pages):
    """Dynamic shared memory of one ``"unit"`` block (the formula of
    ``unit_smem_bytes`` in ``csrc/ragged_paged_attention.cu``): two
    mbarriers; a double buffer of UNIT_CHUNK staged pages in ``el``-byte
    values (K rows padded by UNIT_ROW_PAD bytes, V rows packed) and their
    int8 row scales; in fp32 the R query rows, the chunk's scores, page
    maxima, running maxima, corr and sums, acc, m and l; the unit's
    tokens, contexts and page counts, and its ``unit_pages`` table
    entries."""
    ring = 2 * UNIT_CHUNK * P * ((D * el + UNIT_ROW_PAD) + D * el)
    scales = 2 * UNIT_CHUNK * 2 * P * 4 if quant else 0
    floats = (R * (D + 4) + UNIT_CHUNK * R * (P + 1) + 4 * UNIT_CHUNK * R
              + R * D + 2 * R)
    return 16 + ring + scales + 4 * floats + 4 * (3 * q_block + 1
                                                  + unit_pages)


def qblock_variant(q, k_pages, v_pages, plan, k_scales=None, v_scales=None):
    """The rule: ``"unit"`` when the ``"unit"`` kernel takes these operands
    (a page size of UNIT_PAGE_SIZES, head_dim % 16 == 0, every pool and
    scale array 16-byte aligned, a block that fits shared memory), else
    ``"runtime"``, which takes every shape. Depends on shapes, types and
    addresses only (``plan`` gives the q-block size, the job width and the
    table width)."""
    T, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    pools = [t for t in (k_pages, v_pages, k_scales, v_scales)
             if t is not None]
    if P not in UNIT_PAGE_SIZES or D % 16 \
            or any(t.data_ptr() % 16 for t in pools):
        return "runtime"
    unit_pages = min(plan.dev["job_page"].shape[1], plan.pages_per_seq)
    if unit_smem_bytes(k_pages.element_size(), k_scales is not None,
                       plan.q_block * (H // KVH), P, D, plan.q_block,
                       unit_pages) > SMEM_LIMIT:
        return "runtime"
    return "unit"


def token_slice(G, D, splits):
    """The G x D outputs of a (token, kv head) that each of ``splits``
    blocks folds: an even count (``token_slice`` in the kernel)."""
    return 2 * -(-G * D // (2 * splits))


def token_smem_bytes(el, quant, G, D, pages_per_seq, splits,
                     round_pages=None):
    """Dynamic shared memory of one ``"cluster"`` block (the formula of
    ``token_split_smem_bytes`` in ``csrc/ragged_paged_attention.cu``): an
    mbarrier, the block's c pages of a round (:func:`token_round_pages` by
    default) in ``el``-byte values (K rows padded by 16 bytes, V rows
    packed) and their int8 row scales; in fp32 q, the block's scores of a
    round (G rounded up to four a key), the round's page maxima, corr and
    sums for every row and, with more than one split, pv over the block's
    slice, the slice's acc, m and l; and the block's table entries."""
    c = token_round_pages(splits) if round_pages is None else round_pages
    P = SPLIT_PAGE
    page = P * ((D * el + 16) + D * el)
    per_round = splits * c
    slice_ = token_slice(G, D, splits)
    floats = (G * (D + 4) + c * P * -(-G // 4) * 4 + 3 * per_round * G
              + (per_round * slice_ if splits > 1 else 0) + slice_ + 2 * G)
    cap = c * -(-pages_per_seq // per_round)
    return (16 + c * page + (c * 2 * P * 4 if quant else 0) + 4 * floats
            + 4 * cap)


def token_variant(q, k_pages, v_pages, pages_per_seq, n_sm, k_scales=None,
                  v_scales=None):
    """The rule: ``("cluster", splits)`` when the ``"cluster"`` kernel
    takes these operands (page size SPLIT_PAGE, head_dim % 16 == 0, every
    pool and scale array 16-byte aligned, a block that fits shared
    memory), else ``("block", 0)``. Depends on shapes, types and addresses
    only."""
    T, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    pools = [t for t in (k_pages, v_pages, k_scales, v_scales)
             if t is not None]
    if P != SPLIT_PAGE or D % 16 or H % KVH or pages_per_seq < 1 \
            or T > 65535 or any(t.data_ptr() % 16 for t in pools):
        return "block", 0
    splits = token_splits(T, KVH, pages_per_seq, n_sm)
    if token_smem_bytes(k_pages.element_size(), k_scales is not None,
                        H // KVH, D, pages_per_seq, splits) > SMEM_LIMIT:
        return "block", 0
    return "cluster", splits


# ---------------------------------------------------------------------------
# kernel wrappers: a CUDA tensor launches the kernel, a CPU tensor runs
# the plain version, anything else raises
# ---------------------------------------------------------------------------

def _check_cuda_inputs(q, k_pages, v_pages, plan, impl, k_scales=None,
                       v_scales=None):
    if plan.impl != impl:
        raise ValueError(f"plan was built for {plan.impl!r}, not {impl!r}")
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
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in plan.dev.items():
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"plan tensor {name} must be contiguous int32 "
                             f"on {q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    T, H, D = q.shape
    KVH, _, P, Dk = k_pages.shape
    if Dk != D or H % KVH or T != plan.num_tokens or P != plan.page_size:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)} and plan of "
                         f"{plan.num_tokens} tokens, page {plan.page_size}")


def _launch(fn_name, q, pages, plan, sm_scale, counters, extra=()):
    """Launch ``fn_name`` on ``q``, ``pages`` (K and V, then the scales of
    int8 pages), the plan's device arrays and the ints ``extra`` after the
    scale, counted in ``counters`` (see ``_build.launch``); returns the
    output."""
    T, H, D = q.shape
    KVH, NP, P, _ = pages[0].shape
    d = plan.dev
    out = torch.empty_like(q)
    if plan.impl == "qblock":
        # the grid is units' rows; the kernel reads the live count. The
        # unit kernel's page size is in its name, and it takes the table
        # width; the runtime kernel takes the page size
        arrays = [d[n] for n in ("row_slot", "row_ctx", "job_page",
                                 "units", "n_units")]
        grid = (plan.q_block, d["units"].shape[0], d["job_page"].shape[1])
        sizes = ((T, H, KVH, D, NP, P) + grid if "_rt" in fn_name
                 else (T, H, KVH, D, NP) + grid + (plan.pages_per_seq,))
    else:
        arrays = [d[n] for n in ("tok_slot", "tok_ctx", "tables")]
        sizes = (T, H, KVH, D, NP, P, d["tables"].shape[1])
    args = [ctypes.c_int(_build.attention_dtype_code(q.dtype,
                                                     pages[0].dtype))] + [
        ctypes.c_void_p(t.data_ptr()) for t in (q, *pages, out, *arrays)
    ] + [ctypes.c_int(x) for x in sizes] + [ctypes.c_float(sm_scale)] + [
        ctypes.c_int(x) for x in extra]
    _build.launch(fn_name, q.device, args, counters)
    return out


def _qblock_cuda(fn, q, k_pages, v_pages, plan, sm_scale, k_scales,
                 v_scales, variant):
    """Check, pick the variant (or take the forced one), launch, count:
    ``fn`` is the wrapper whose counters the launch adds to."""
    _check_cuda_inputs(q, k_pages, v_pages, plan, "qblock", k_scales,
                       v_scales)
    rule = qblock_variant(q, k_pages, v_pages, plan, k_scales, v_scales)
    if variant == "unit" and rule != "unit":
        raise ValueError(f"the unit kernel does not take pages "
                         f"{tuple(k_pages.shape)} with q {tuple(q.shape)}")
    variant = variant or rule
    quant = k_scales is not None
    pages = (k_pages, v_pages) + ((k_scales, v_scales) if quant else ())
    name = "ptt_ragged_qblock" + ("_rt" if variant == "runtime" else
                                  f"_p{k_pages.shape[2]}") \
        + ("_q8" if quant else "")
    return _launch(name, q, pages, plan, sm_scale,
                   launch_counters(fn, variant, q, k_pages, quant))


def qblock_attention(q, k_pages, v_pages, plan, sm_scale, k_scales=None,
                     v_scales=None, variant=None):
    """Kernel 6 (q-block grid), or B7 (:func:`qblock_attention_q8`) when
    ``k_scales``/``v_scales`` come with int8 pages. ``plan`` from
    :func:`make_plan` with ``impl="qblock"``. ``variant`` None takes the
    rule (:func:`qblock_variant`); ``"unit"`` / ``"runtime"`` forces one
    kernel (a forced ``"unit"`` raises where it does not apply), CUDA
    tensors only. Kernel 6 counts its CUDA launches in
    ``qblock_attention.launches`` and, by variant, in ``.unit_launches``
    and ``.runtime_launches``; those of a 16-bit q over fp32 pages also
    in ``.mixed_launches``."""
    if k_scales is not None:
        return qblock_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                                   plan, sm_scale, variant)
    if variant not in (None, *QBLOCK_VARIANTS):
        raise ValueError(f"variant {variant!r}, expected one of "
                         f"{QBLOCK_VARIANTS}")
    if q.device.type == "cpu":
        return qblock_attention_plain(q, k_pages, v_pages, plan, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention for device {q.device}")
    return _qblock_cuda(qblock_attention, q, k_pages, v_pages, plan,
                        sm_scale, None, None, variant)


qblock_attention.launches = 0
qblock_attention.unit_launches = 0
qblock_attention.runtime_launches = 0
qblock_attention.mixed_launches = 0
qblock_attention.launches_by_dtype = {}


def qblock_attention_q8(q, k_pages, v_pages, k_scales, v_scales, plan,
                        sm_scale, variant=None):
    """Kernel B7: the q-block grid over int8 pages with fp32 row scales
    ``[KVH, NP, P]``, ``variant`` as in :func:`qblock_attention`. Counts
    its CUDA launches in ``qblock_attention_q8.launches`` and, by
    variant, in ``.unit_launches`` and ``.runtime_launches``."""
    if variant not in (None, *QBLOCK_VARIANTS):
        raise ValueError(f"variant {variant!r}, expected one of "
                         f"{QBLOCK_VARIANTS}")
    if q.device.type == "cpu":
        return qblock_attention_plain(q, k_pages, v_pages, plan, sm_scale,
                                      k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention for device {q.device}")
    return _qblock_cuda(qblock_attention_q8, q, k_pages, v_pages, plan,
                        sm_scale, k_scales, v_scales, variant)


qblock_attention_q8.launches = 0
qblock_attention_q8.unit_launches = 0
qblock_attention_q8.runtime_launches = 0
qblock_attention_q8.launches_by_dtype = {}


def _token_cuda(fn, q, k_pages, v_pages, plan, sm_scale, k_scales,
                v_scales, variant):
    """Check, pick the variant (or take the forced one), launch, count:
    ``fn`` is the wrapper whose counters the launch adds to."""
    _check_cuda_inputs(q, k_pages, v_pages, plan, "token", k_scales,
                       v_scales)
    rule, splits = token_variant(q, k_pages, v_pages,
                                 plan.dev["tables"].shape[1],
                                 _sm_count(q.device.index), k_scales,
                                 v_scales)
    if variant == "cluster" and rule != "cluster":
        raise ValueError(f"the cluster kernel does not take pages "
                         f"{tuple(k_pages.shape)} with q {tuple(q.shape)}")
    variant = variant or rule
    quant = k_scales is not None
    pages = (k_pages, v_pages) + ((k_scales, v_scales) if quant else ())
    name = "ptt_ragged_token" + ("_split" if variant == "cluster" else "") \
        + ("_q8" if quant else "")
    return _launch(name, q, pages, plan, sm_scale,
                   launch_counters(fn, variant, q, k_pages, quant),
                   (splits, token_round_pages(splits))
                   if variant == "cluster" else ())


def token_attention(q, k_pages, v_pages, plan, sm_scale, k_scales=None,
                    v_scales=None, variant=None):
    """Kernel 8 (per-token grid), or B9 (:func:`token_attention_q8`) when
    ``k_scales``/``v_scales`` come with int8 pages. ``plan`` from
    :func:`make_plan` with ``impl="token"``. ``variant`` None takes the
    rule (:func:`token_variant`); ``"cluster"`` / ``"block"`` forces one
    kernel (a forced ``"cluster"`` raises where it does not apply), CUDA
    tensors only. Kernel 8 counts its CUDA launches in
    ``token_attention.launches`` and, by variant, in
    ``.cluster_launches`` and ``.block_launches``; those of a 16-bit q
    over fp32 pages also in ``.mixed_launches``."""
    if k_scales is not None:
        return token_attention_q8(q, k_pages, v_pages, k_scales, v_scales,
                                  plan, sm_scale, variant)
    if variant not in (None, *TOKEN_VARIANTS):
        raise ValueError(f"variant {variant!r}, expected one of "
                         f"{TOKEN_VARIANTS}")
    if q.device.type == "cpu":
        return token_attention_plain(q, k_pages, v_pages, plan, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention for device {q.device}")
    return _token_cuda(token_attention, q, k_pages, v_pages, plan, sm_scale,
                       None, None, variant)


token_attention.launches = 0
token_attention.cluster_launches = 0
token_attention.block_launches = 0
token_attention.mixed_launches = 0
token_attention.launches_by_dtype = {}


def token_attention_q8(q, k_pages, v_pages, k_scales, v_scales, plan,
                       sm_scale, variant=None):
    """Kernel B9: the per-token grid over int8 pages with fp32 row scales
    ``[KVH, NP, P]``, ``variant`` as in :func:`token_attention`. Counts
    its CUDA launches in ``token_attention_q8.launches`` and, by variant,
    in ``.cluster_launches`` and ``.block_launches``."""
    if variant not in (None, *TOKEN_VARIANTS):
        raise ValueError(f"variant {variant!r}, expected one of "
                         f"{TOKEN_VARIANTS}")
    if q.device.type == "cpu":
        return token_attention_plain(q, k_pages, v_pages, plan, sm_scale,
                                     k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged attention for device {q.device}")
    return _token_cuda(token_attention_q8, q, k_pages, v_pages, plan,
                       sm_scale, k_scales, v_scales, variant)


token_attention_q8.launches = 0
token_attention_q8.cluster_launches = 0
token_attention_q8.block_launches = 0
token_attention_q8.launches_by_dtype = {}


def ragged_paged_attention(q, k_pages, v_pages, block_tables, seq_slots,
                           q_starts, q_lens, context_lens, *, sm_scale=None,
                           impl="qblock", q_block=DEFAULT_QBLOCK, plan=None,
                           k_scales=None, v_scales=None):
    """Mixed prefill+decode attention over a shared paged KV cache.

    q               [tokens, heads, head_dim], the flat packed batch
    k_pages/v_pages [kv_heads, num_pages, page_size, head_dim]
    block_tables    [slots, pages_per_seq] int32 host array (unused
                    entries = 0)
    seq_slots, q_starts, q_lens, context_lens  [nseq] int32 host arrays
    impl            "qblock" (kernel 6, B7 on int8 pages) or "token"
                    (kernel 8, B9 on int8 pages)
    plan            a :func:`make_plan` result for these descriptors, to
                    skip rebuilding the schedule (the cache builds it once
                    per forward)
    k_scales/v_scales [kv_heads, num_pages, page_size] float32 row scales
                    of int8 pages (None: native pages)
    -> [tokens, heads, head_dim]; rows outside every span are garbage.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pages need both k_scales and v_scales")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if plan is None:
        plan = make_plan(q.shape[0], seq_slots, q_starts, q_lens,
                         context_lens, block_tables, k_pages.shape[2],
                         impl=impl, q_block=q_block, device=q.device)
    if impl == "qblock":
        return qblock_attention(q, k_pages, v_pages, plan, sm_scale,
                                k_scales, v_scales)
    if impl == "token":
        return token_attention(q, k_pages, v_pages, plan, sm_scale,
                               k_scales, v_scales)
    raise ValueError(f"impl {impl!r} not in {IMPLS}")


def ragged_paged_attention_reference(q, k_pages, v_pages, block_tables,
                                     seq_slots, q_starts, q_lens,
                                     context_lens):
    """Dense oracle: per sequence, gather its context from the pages and
    run plain causal softmax attention for its span, scale 1/sqrt(d).
    Rows outside every span are zero."""
    T, H, D = q.shape
    KVH, _, P, _ = k_pages.shape
    G = H // KVH
    out = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    tbl = np.asarray(block_tables)
    for slot, qs, ql, ctx in zip(*(np.asarray(a).reshape(-1).tolist()
                                   for a in (seq_slots, q_starts, q_lens,
                                             context_lens))):
        pages = torch.as_tensor(tbl[slot, :-(-ctx // P)].astype(np.int64),
                                device=q.device)
        ks = k_pages[:, pages].reshape(KVH, -1, D)[:, :ctx].float()
        vs = v_pages[:, pages].reshape(KVH, -1, D)[:, :ctx].float()
        for j in range(ql):
            vis = ctx - ql + j + 1                 # causal inside the span
            qg = q[qs + j].reshape(KVH, G, D).float()
            s = torch.einsum("kgd,ksd->kgs", qg, ks[:, :vis]) / math.sqrt(D)
            o = torch.einsum("kgs,ksd->kgd", torch.softmax(s, -1),
                             vs[:, :vis])
            out[qs + j] = o.reshape(H, D)
    return out.to(q.dtype)
