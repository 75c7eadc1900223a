"""Autoregressive generation and the KV caches behind it (port of
``paddle_tpu/models/generation.py``).

* The int8 KV row codec: :func:`quantize_kv_rows`,
  :func:`dequantize_kv_rows` and the capacity arithmetic
  :func:`kv_page_nbytes`.

* :class:`KVCache`: per-layer concat cache for ``generate`` and beam
  search.
* :class:`PagedKVCache`: one uniform batch over fixed pages; the prompt
  prefills densely through SDPA, every decode step runs the paged decode
  kernel.
* :class:`SlotPagedKVCache`: continuous batching. Every slot has its own
  context length and lifecycle over one shared, refcounted page pool: a
  slot is **assigned** a prompt on admission (leading full blocks that hit
  the hash-chained prefix index map onto already-filled pages), then
  either runs **ragged** ticks (its new tokens packed with other slots'
  into one flat batch) or, under the legacy scheduler, **prefill** chunks
  and fixed-shape ``[max_batch, 1]`` **decode** steps, and is **freed** on
  completion. Page 0 is a scratch page that is never allocated: padding
  tokens and idle decode rows write there and unused table entries point
  there. Writing into a shared page (refcount > 1 or registered in the
  prefix index) copies it first. With ``kv_dtype="int8"`` the pages hold
  int8 codes and every ``(kv head, page, slot)`` row an fp32 scale beside
  them.
* :class:`GenerationMixin`: ``generate`` (greedy, seeded sampling, beam
  search) for a causal LM whose forward takes ``cache=``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import amp
from ..nn.functional import scaled_dot_product_attention
from ..ops.paged_attention import paged_attention
from ..ops.ragged_paged_attention import (DEFAULT_QBLOCK, RaggedPlan,
                                          plan_arrays,
                                          ragged_paged_attention)

#: kv_dtype values SlotPagedKVCache takes; "auto" means "native"
KV_DTYPES = ("auto", "int8", "native")


def quantize_kv_rows(x):
    """Symmetric int8 row codec for KV pages (reference ``:28-40``):
    abs-max over the last axis, one fp32 scale per ``[..., d]`` row.
    ``x [..., d]`` -> ``(int8 [..., d], float32 scales [...])``. Computed
    in fp32 whatever ``x``'s type; ``torch.round`` rounds half to even,
    as ``jnp.rint`` does. The divisor 127 is a tensor: a Python scalar
    would let CUDA multiply by its reciprocal instead of dividing."""
    xf = x.float()
    amax = xf.abs().amax(-1).clamp_min(1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv_rows`: the fp32 product, then a cast
    to ``dtype`` (error per element <= ``scale / 2``)."""
    return (q.float() * scale[..., None]).to(dtype)


def kv_page_nbytes(kv_heads, head_dim, page_size=16, kv_dtype="native",
                   native_dtype="float32", num_layers=1):
    """Device bytes ONE page pins across K and V (plus the int8 row
    scales) for ``num_layers`` attention layers. int8 against bf16 is
    ``2d / (d + 4)``, 1.94x at d = 128. ``native_dtype`` names a torch
    dtype, as the reference names a numpy one."""
    elems = int(kv_heads) * int(page_size) * int(head_dim)
    if str(kv_dtype) == "int8":
        per = elems + int(kv_heads) * int(page_size) * 4   # + f32 scales
    else:
        per = elems * getattr(torch, native_dtype).itemsize
    return 2 * per * int(num_layers)                       # K and V


def block_hash_chain(tokens, page_size, parent=b""):
    """Chained block hashes for prefix caching: block ``i``'s key is
    ``sha1(key_{i-1} || tokens_of_block_i)``, so two prompts share a key
    iff they share the whole prefix up to and including that block. One
    digest per FULL block."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    out = []
    for i in range(len(arr) // int(page_size)):
        h = hashlib.sha1()
        h.update(parent)
        h.update(arr[i * page_size:(i + 1) * page_size].tobytes())
        parent = h.digest()
        out.append(parent)
    return out


def _page_gather(pages, table, scales=None, dtype=None):
    """Read pages back as dense sequences: ``pages [kv, num_pages, P, d]``
    and ``table [..., n]`` -> ``[..., n * P, kv, d]``. int8 pages come
    with their row ``scales [kv, num_pages, P]`` and are dequantised to
    ``dtype``."""
    g = pages[:, table]
    if scales is not None:
        g = dequantize_kv_rows(g, scales[:, table], dtype)
    g = g.movedim(0, -2)                          # [..., n, P, kv, d]
    return g.reshape(*g.shape[:-4], -1, *g.shape[-2:])


class KVCache:
    """Per-attention-layer concat cache. ``update`` returns the full K/V so
    far (including the new tokens); ``pos`` is the filled length, advanced
    once per model forward."""

    def __init__(self):
        self.pos = 0
        self._store = {}

    def update(self, layer, k_new, v_new):
        key = id(layer)
        if key in self._store:
            k_old, v_old = self._store[key]
            k = torch.cat([k_old, k_new], dim=1)
            v = torch.cat([v_old, v_new], dim=1)
        else:
            k, v = k_new, v_new
        self._store[key] = (k.detach(), v.detach())
        return k, v

    def advance(self, s):
        self.pos += int(s)

    def reorder(self, idx):
        """Gather the cache along the batch axis (beam-search hop: beam
        ``b``'s continuation may extend a different parent beam)."""
        for key, (k, v) in self._store.items():
            i = torch.as_tensor(idx, device=k.device)
            self._store[key] = (k[i], v[i])

    def reset(self):
        self.pos = 0
        self._store.clear()

    def attend(self, layer, q, k, v):
        """Update the store with this step's K/V and attend over all of it:
        ``q [b, s, heads, d]`` -> ``[b, s, heads, d]``. q, k and v keep
        their dtypes, as the reference's store does: in a bf16 model the
        rope makes q and k fp32 (ROADMAP C24) and v stays bf16, and SDPA
        computes the mix in fp32."""
        k, v = self.update(layer, k, v)
        return scaled_dot_product_attention(q, k, v, is_causal=True)


class PagedKVCache(KVCache):
    """Paged (block-table) KV cache for one batch decoded in lockstep.

    K/V live in fixed-size pages ``[kv_heads, num_pages, page_size, d]``
    per attention layer, and a block table shared by the layers maps each
    sequence's positions to its pages. The allocation is static and
    contiguous: sequence ``b`` owns pages ``[b * pps, (b + 1) * pps)``, so
    there is no scratch page. Prefill writes the prompt's K/V into the
    pages and attends densely through SDPA (reading a prefix back from the
    pages when the cache already holds one); every decode step writes one
    position and runs :func:`paged_attention` with ``ctx = pos + 1``."""

    def __init__(self, page_size=16, max_len=2048):
        super().__init__()
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_seq = -(-self.max_len // self.page_size)
        self._pools = {}          # id(layer) -> (k_pages, v_pages)
        self._tables = None       # [batch, pages_per_seq] int32
        self._batch = None
        self._idx_key = None
        self._idx = None

    def reset(self):
        super().reset()
        self._pools.clear()
        self._tables = None
        self._batch = None
        self._idx_key = None
        self._idx = None

    def _ensure_tables(self, batch):
        if self._tables is None:
            self._batch = batch
            self._tables = (np.arange(batch)[:, None] * self.pages_per_seq
                            + np.arange(self.pages_per_seq)[None, :]
                            ).astype(np.int32)
        return self._tables

    def _pool(self, layer, kv_heads, d, dtype, device, batch):
        key = id(layer)
        if key not in self._pools:
            shape = (kv_heads, batch * self.pages_per_seq, self.page_size, d)
            self._pools[key] = (torch.zeros(shape, dtype=dtype, device=device),
                                torch.zeros(shape, dtype=dtype, device=device))
        return self._pools[key]

    def _step_indices(self, start, s, b, device):
        """Scatter and kernel indices of this step, the same for every
        layer: computed once per (start, s, batch)."""
        key = (start, s, b)
        if self._idx_key != key:
            pos = np.arange(start, start + s)
            self._idx = (
                torch.from_numpy(self._tables[:, pos // self.page_size]
                                 .astype(np.int64)).to(device),     # [b, s]
                torch.from_numpy(np.broadcast_to(
                    pos % self.page_size, (b, s)).astype(np.int64)).to(device),
                torch.from_numpy(self._tables).to(device),
                torch.full((b,), start + s, dtype=torch.int32, device=device))
            self._idx_key = key
        return self._idx

    def attend(self, layer, q, k, v):
        """The pools take k's dtype, as the reference's (``generation.py:
        303``): fp32 in a bf16 model, whose rope makes k fp32 (ROADMAP
        C25), under AMP too; v is cast to it where it is written. A decode
        step is the reference's op ``"paged_attention"`` (``:354``), whose
        one tensor argument is q: AMP casts q alone, to 16 bits under O2
        (ROADMAP C29), and the output takes q's dtype."""
        b, s, kv_heads, d = k.shape
        if self._batch is not None and self._batch != b:
            raise ValueError(f"PagedKVCache was allocated for batch "
                             f"{self._batch}, got {b}; call reset() first")
        self._ensure_tables(b)
        k_pages, v_pages = self._pool(layer, kv_heads, d, k.dtype, k.device,
                                      b)
        start = self.pos
        if start + s > self.max_len:
            raise ValueError(f"PagedKVCache overflow: {start}+{s} > "
                             f"{self.max_len}")
        page_ids, slot_ids, tables, ctx = self._step_indices(start, s, b,
                                                             k.device)
        # in place: the pool is ours ([kv, b, s, d] rows from [b, s, kv, d])
        k_pages[:, page_ids, slot_ids] = k.permute(2, 0, 1, 3)
        v_pages[:, page_ids, slot_ids] = v.permute(2, 0, 1, 3).to(
            v_pages.dtype)
        if s > 1:
            if start > 0:
                # a reused cache or chunked prefill: read the whole prefix
                # back; SDPA's bottom-right causal alignment handles sq != sk
                n_pages = -(-(start + s) // self.page_size)
                tb = torch.from_numpy(self._tables[:, :n_pages]
                                      .astype(np.int64)).to(k.device)
                k = _page_gather(k_pages, tb)[:, :start + s]
                v = _page_gather(v_pages, tb)[:, :start + s]
            return scaled_dot_product_attention(q, k, v, is_causal=True)
        # the reference's op: only q is its tensor argument, so AMP casts
        # q alone (16-bit under O2, over the fp32 pages)
        (q,) = amp.amp_cast_inputs("paged_attention", [q])
        return paged_attention(q[:, 0], k_pages, v_pages, tables, ctx)[:, None]


class StagedBuffer:
    """A tensor on ``device`` that is refilled from a host array before
    each forward, outside any captured region, so that a CUDA graph
    captured over it reads each tick's values. On CUDA the array goes
    through a pinned host copy and a non-blocking copy on the current
    stream (the pinned copy is reused once the last copy out of it has
    completed); on the CPU it is copied in place."""

    def __init__(self, shape, dtype, device):
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self._pinned = self._copied = None
        if self.dev.is_cuda:
            self._pinned = torch.zeros(shape, dtype=dtype, pin_memory=True)
            self._copied = torch.cuda.Event()

    def fill(self, array):
        src = torch.from_numpy(np.ascontiguousarray(array)).to(self.dev.dtype)
        if src.shape != self.dev.shape:
            raise ValueError(f"staged buffer {tuple(self.dev.shape)} "
                             f"filled with {tuple(src.shape)}")
        if self._pinned is None:
            self.dev.copy_(src)
            return
        self._copied.synchronize()
        self._pinned.copy_(src)
        self.dev.copy_(self._pinned, non_blocking=True)
        self._copied.record()


def _staged(arrays, device, dtypes=None):
    """``{name: StagedBuffer}`` shaped like ``arrays`` (int32 unless
    ``dtypes`` names another torch dtype)."""
    dtypes = dtypes or {}
    return {n: StagedBuffer(a.shape, dtypes.get(n, torch.int32), device)
            for n, a in arrays.items()}


class SlotPagedKVCache:
    """Per-slot paged KV cache over a shared refcounted page pool.

    Each forward is armed by one of :meth:`begin_ragged` (the ragged
    scheduler), :meth:`begin_prefill` or :meth:`begin_decode` (the legacy
    two-program scheduler). ``ragged_impl`` picks the ragged attention
    grid: ``"qblock"`` (the default) or ``"token"`` (the per-token escape
    hatch). ``kv_dtype`` is one of :data:`KV_DTYPES`; ``None`` and
    ``"auto"`` mean ``"native"`` (the model's dtype), ``"int8"`` stores
    int8 codes with one fp32 scale per ``(kv head, page, slot)`` row,
    quantised on scatter (:func:`quantize_kv_rows`).

    A ragged step and a decode step read their scatter indices, block
    tables, contexts and ragged schedule from buffers of fixed shape, one
    set per tick shape (the ragged tick's token count, or the decode
    step), which the ``begin_*`` call refills from the host. The q-block
    schedule takes its fixed grid (``max_slots=max_batch`` in
    :func:`~paddle_tpu_torch.ops.ragged_paged_attention.plan_arrays`). So
    a forward over these buffers launches the same kernels at the same
    shapes whatever the tick holds, and a CUDA graph captured over it
    replays every later tick of its shape. ``device`` is where those
    buffers live (``None``: the CPU); it must be the device of the
    model's activations. A step ends with :meth:`end_step`, the one place
    its lengths advance: the model's forward leaves a slot cache's
    lengths alone, so a replayed graph, which runs no Python, needs
    nothing of it."""

    def __init__(self, max_batch, page_size=16, max_len=2048,
                 num_pages=None, enable_prefix_cache=True,
                 ragged_impl="qblock", kv_dtype=None, device=None):
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_seq = -(-self.max_len // self.page_size)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.ragged_impl = ragged_impl
        kv_dtype = "auto" if kv_dtype is None else str(kv_dtype).lower()
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        self.kv_dtype = "native" if kv_dtype == "auto" else kv_dtype
        self.kv_quant = self.kv_dtype == "int8"
        self._scales = {}                 # id(layer) -> (k_scales, v_scales)
        # +1: page 0 is the never-allocated scratch page
        self.num_pages = (int(num_pages) if num_pages is not None
                          else self.max_batch * self.pages_per_seq + 1)
        if self.num_pages < self.pages_per_seq + 1:
            raise ValueError("num_pages must cover one full sequence")
        self._free = deque(range(1, self.num_pages))
        self._ref = np.zeros(self.num_pages, np.int32)
        self._index = OrderedDict()       # block digest -> page (LRU order)
        self._page_digest = {}            # page -> digest (registered)
        self._chain = [None] * self.max_batch   # per-slot block digests
        self._pools = {}                  # id(layer) -> (k_pages, v_pages)
        self._tables = np.zeros((self.max_batch, self.pages_per_seq),
                                np.int32)
        self._n_blocks = np.zeros(self.max_batch, np.int32)
        self.lens = np.zeros(self.max_batch, np.int32)   # filled ctx/slot
        self._mode = None        # ("ragged", spans) | ("prefill", slot)
        #                          | ("decode", active mask)
        self._idx = None                  # per-forward index memo
        self._prefill_valid = None        # real tokens of a padded chunk
        self.device = torch.device("cpu" if device is None else device)
        if self.device.type == "cuda" and self.device.index is None:
            # where tensors made on "cuda" land, as activations report it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._steps = {}                  # tick shape -> staged buffers
        self.prefix_hits = 0              # full blocks served from the index
        self.prefix_misses = 0            # full blocks that had to prefill
        self.cow_copies = 0
        self.prefix_evictions_device = 0
        # speculative decoding's rejections (rollback())
        self.rollbacks = 0
        self.tokens_rolled_back = 0

    # -- page allocator ------------------------------------------------------
    def _alloc_page(self):
        if not self._free:
            self._evict_lru()
        if not self._free:
            raise RuntimeError(
                f"KV page pool exhausted ({self.num_pages - 1} pages, all "
                f"backing live sequences)")
        page = self._free.popleft()
        self._ref[page] = 1
        return int(page)

    def _evict_lru(self):
        """Reclaim the least-recently-used prefix-index entry whose page
        no live slot maps (refcount 1 == the index's own ref)."""
        for digest in list(self._index):
            page = self._index[digest]
            if self._ref[page] == 1:
                del self._index[digest]
                del self._page_digest[page]
                self._ref[page] = 0
                self._free.append(page)
                self.prefix_evictions_device += 1
                return True
        return False

    def _decref(self, page):
        page = int(page)
        if page == 0:
            return
        if self._ref[page] <= 0:
            raise RuntimeError(f"page {page} refcount underflow")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    def _ensure_blocks(self, slot, tokens):
        """Allocate fresh pages so ``slot`` can hold ``tokens`` context."""
        need = -(-int(tokens) // self.page_size)
        for i in range(int(self._n_blocks[slot]), need):
            self._tables[slot, i] = self._alloc_page()
        if need > self._n_blocks[slot]:
            self._n_blocks[slot] = need

    def _make_writable(self, slot, blk):
        """Copy-on-write for a block whose page is shared (mapped by
        another slot, or registered in the prefix index)."""
        page = int(self._tables[slot, blk])
        if page == 0:
            return
        if self._ref[page] <= 1 and page not in self._page_digest:
            return
        new = self._alloc_page()
        for pair in (*self._pools.values(), *self._scales.values()):
            for pool in pair:                  # in place, every layer
                pool[:, new] = pool[:, page]
        self._decref(page)
        self._tables[slot, blk] = new
        self.cow_copies += 1

    @property
    def free_page_count(self):
        return len(self._free)

    @property
    def used_page_count(self):
        return self.num_pages - 1 - len(self._free)

    @property
    def page_nbytes(self):
        """Device bytes one page pins across every layer's K and V pools
        and int8 row scales; 0 until the first forward allocates the
        pools."""
        total = sum(a.nbytes + b.nbytes for a, b in (*self._pools.values(),
                                                     *self._scales.values()))
        return total // self.num_pages if total else 0

    def rollback(self, slot, n):
        """Truncate the last ``n`` context tokens of ``slot``: speculative
        decoding's rejection path (a verify span wrote K/V for ``k``
        drafted tokens and the target model accepted ``m``). Pages wholly
        past the new end leave the slot's table (refcount - 1): a page
        another slot maps, or one the prefix index registered, keeps its
        other references; a private page returns to the free list. The
        kept partial page may hold stale K/V (and int8 row scales) past
        the new length: every reader's context bound masks them, and the
        next write overwrites them. The device's block table and schedule
        are refilled from these host tables at the next ``begin_*``, so a
        replayed tick never reads an unmapped entry. Returns ``n``; raises
        when ``n`` exceeds the context."""
        slot = int(slot)
        n = int(n)
        if n <= 0:
            return 0
        if n > int(self.lens[slot]):
            raise ValueError(f"rollback {n} > slot context "
                             f"{int(self.lens[slot])}")
        new_len = int(self.lens[slot]) - n
        keep = -(-new_len // self.page_size)
        for blk in range(keep, int(self._n_blocks[slot])):
            self._decref(int(self._tables[slot, blk]))
            self._tables[slot, blk] = 0
        self._n_blocks[slot] = keep
        self.lens[slot] = new_len
        self.rollbacks += 1
        self.tokens_rolled_back += n
        return n

    # -- engine-facing lifecycle -------------------------------------------
    def assign(self, slot, prompt):
        """Admission: map the prompt's leading full blocks that hit the
        prefix index onto already-filled pages. Returns ``(cached_tokens,
        hit_blocks, missed_blocks)``; the caller prefills only
        ``prompt[cached_tokens:]``. At least one token is always left to
        prefill (the model must produce logits for the last prompt
        token)."""
        slot = int(slot)
        self.free(slot)
        prompt = np.asarray(prompt).reshape(-1)
        chain = (block_hash_chain(prompt, self.page_size)
                 if self.enable_prefix_cache else [])
        self._chain[slot] = chain
        matchable = min(len(chain), (len(prompt) - 1) // self.page_size)
        matched = 0
        for i in range(matchable):
            page = self._index.get(chain[i])
            if page is None:
                break
            self._index.move_to_end(chain[i])      # LRU touch
            self._ref[page] += 1
            self._tables[slot, i] = page
            matched += 1
        self._n_blocks[slot] = matched
        cached = matched * self.page_size
        self.lens[slot] = cached
        missed = (max(len(prompt) // self.page_size - matched, 0)
                  if self.enable_prefix_cache else 0)
        self.prefix_hits += matched
        self.prefix_misses += missed
        return cached, matched, missed

    def commit_prefix(self, slot):
        """Register the slot's filled full prompt blocks in the prefix
        index. A digest another slot registered first wins. Returns the
        number of new registrations."""
        if not self.enable_prefix_cache:
            return 0
        slot = int(slot)
        chain = self._chain[slot] or []
        registered = 0
        for i, digest in enumerate(chain):
            if i >= int(self._n_blocks[slot]):
                break
            page = int(self._tables[slot, i])
            if digest in self._index or page == 0 \
                    or page in self._page_digest:
                continue
            self._index[digest] = page
            self._page_digest[page] = digest
            self._ref[page] += 1          # the index's own reference
            registered += 1
        return registered

    def begin_prefill(self, slot, n_valid=None):
        """Arm the next forward as a prefill chunk for ``slot``, writing at
        position ``lens[slot]``. ``n_valid`` counts the real tokens when the
        engine pads the chunk to a bucket: pad positions write to the
        scratch page and do not advance the context."""
        self._mode = ("prefill", int(slot))
        self._idx = None
        self._prefill_valid = None if n_valid is None else int(n_valid)

    def begin_decode(self, active_mask):
        """Arm the next forward as one fixed-shape ``[max_batch, 1]``
        decode step; slots where ``active_mask`` is true write and read
        their own pages, the others write to the scratch page."""
        mask = np.asarray(active_mask, bool)
        self._mode = ("decode", mask)
        for i in np.nonzero(mask)[0]:
            self._ensure_blocks(int(i), int(self.lens[i]) + 1)
            self._make_writable(int(i), int(self.lens[i]) // self.page_size)
        self._stage(self.max_batch)

    def begin_ragged(self, spans, num_tokens=None):
        """Arm the next forward as one ragged mixed prefill+decode step.
        ``spans`` lists ``(slot, q_start, n_new)``: the slot's next
        ``n_new`` context tokens sit at ``q_start`` of the flat
        ``[1, num_tokens]`` batch, ``q_start`` non-decreasing. Tokens
        outside every span are padding; ``num_tokens`` ``None`` means the
        spans' end. Pages are allocated, copy-on-write resolved and the
        step's buffers refilled here, once per step."""
        spans = [(int(s), int(qs), int(n)) for s, qs, n in spans]
        for slot, _, n_new in spans:
            start = int(self.lens[slot])
            if start + n_new > self.max_len:
                raise ValueError(f"slot overflow: {start}+{n_new} > "
                                 f"{self.max_len}")
            self._ensure_blocks(slot, start + n_new)
            for blk in range(start // self.page_size,
                             -(-(start + n_new) // self.page_size)):
                self._make_writable(slot, blk)
        self._mode = ("ragged", spans)
        if num_tokens is None:
            num_tokens = max((qs + n for _, qs, n in spans), default=1)
        self._stage(int(num_tokens))

    def end_step(self):
        """End the step its forward ran: advance the lengths by it (a
        prefill chunk by its real tokens)."""
        self.advance(self._prefill_valid
                     if self._mode[0] == "prefill" else 0)

    def free(self, slot):
        slot = int(slot)
        for i in range(int(self._n_blocks[slot])):
            self._decref(self._tables[slot, i])
        self._tables[slot, :] = 0
        self._n_blocks[slot] = 0
        self.lens[slot] = 0
        self._chain[slot] = None

    @property
    def pos(self):
        # a prefill chunk starts at its slot's length; the engines pass
        # explicit per-token positions for the other modes
        if self._mode and self._mode[0] == "prefill":
            return int(self.lens[self._mode[1]])
        return 0

    def advance(self, s):
        """Advance the lengths by the armed step: a prefill chunk of ``s``
        tokens by ``s`` (at most its ``n_valid``), every decode row or
        ragged span by its own tokens."""
        mode, arg = self._mode
        if mode == "prefill":
            n = self._prefill_valid
            self.lens[arg] += int(s) if n is None else min(int(s), n)
        elif mode == "ragged":
            for slot, _, n_new in arg:
                self.lens[slot] += n_new
        else:                                  # decode: the active mask
            self.lens[arg] += 1

    def _stage(self, s):
        """Refill the armed step's buffers (``s`` tokens) from the host and
        point every layer's attention at them."""
        mode, arg = self._mode
        if mode == "decode":
            lens = self.lens.copy()
            wr_blk = np.minimum(lens // self.page_size, self.pages_per_seq - 1)
            host = {"page_ids": np.where(
                        arg, self._tables[np.arange(s), wr_blk], 0)[:, None],
                    "slot_ids": np.where(arg, lens % self.page_size,
                                         0)[:, None],
                    "tables": self._tables,
                    "ctx": np.where(arg, lens + 1, 1)}
            bufs = self._step_buffers(("decode", s), host)
            self._idx = tuple(bufs[n].dev for n in host)
            return
        page_ids = np.zeros(s, np.int64)          # default: scratch page
        slot_ids = np.zeros(s, np.int64)
        for slot, qs, n_new in arg:
            pos = np.arange(self.lens[slot], self.lens[slot] + n_new)
            page_ids[qs:qs + n_new] = self._tables[slot, pos // self.page_size]
            slot_ids[qs:qs + n_new] = pos % self.page_size
        desc = (np.asarray([sl for sl, _, _ in arg], np.int32),
                np.asarray([qs for _, qs, _ in arg], np.int32),
                np.asarray([n for _, _, n in arg], np.int32),
                np.asarray([int(self.lens[sl]) + n for sl, _, n in arg],
                           np.int32))
        tables = self._tables.copy()
        sched = plan_arrays(s, *desc, tables, self.page_size,
                            impl=self.ragged_impl, q_block=DEFAULT_QBLOCK,
                            max_slots=self.max_batch)
        bufs = self._step_buffers(("ragged", s),
                                  dict(sched, page_ids=page_ids,
                                       slot_ids=slot_ids))
        plan = RaggedPlan(self.ragged_impl, s, self.page_size,
                          DEFAULT_QBLOCK, sched,
                          {n: bufs[n].dev for n in sched},
                          self.pages_per_seq)
        self._idx = (bufs["page_ids"].dev, bufs["slot_ids"].dev, tables,
                     desc, plan)

    def _step_buffers(self, key, host):
        """The staged buffers of tick shape ``key``, made at its first
        step, refilled from ``host`` (``{name: array}``)."""
        if key not in self._steps:
            self._steps[key] = _staged(host, self.device, {
                "page_ids": torch.int64, "slot_ids": torch.int64})
        bufs = self._steps[key]
        for name, array in host.items():
            bufs[name].fill(array)
        return bufs

    def _pool(self, layer, kv_heads, d, dtype, device):
        key = id(layer)
        if key not in self._pools:
            shape = (kv_heads, self.num_pages, self.page_size, d)
            pool_dtype = torch.int8 if self.kv_quant else dtype
            self._pools[key] = tuple(
                torch.zeros(shape, dtype=pool_dtype, device=device)
                for _ in "kv")
            if self.kv_quant:
                # scale 1.0 everywhere: the scratch page and never-written
                # slots dequantise to finite values that masks hide
                self._scales[key] = tuple(
                    torch.ones(shape[:-1], device=device) for _ in "kv")
        return self._pools[key]

    def _layer_scales(self, layer):
        """``(k_scales, v_scales)`` of an int8 pool, ``(None, None)`` of a
        native one."""
        return self._scales.get(id(layer), (None, None))

    def _scatter(self, layer, k_pages, v_pages, kt, vt, page_ids, slot_ids):
        """Write this forward's K/V rows ``[kv, s, d]`` into the pages in
        place (``index_put_``), quantised on an int8 pool with the row
        scales written at the same ``(page, slot)``. The reference returns
        new pools from a functional ``.at[].set``; PyTorch can update the
        pool it holds, which saves a copy of every layer's pool per
        tick."""
        if self.kv_quant:
            (kt, ks), (vt, vs) = quantize_kv_rows(kt), quantize_kv_rows(vt)
            k_scales, v_scales = self._scales[id(layer)]
            k_scales[:, page_ids, slot_ids] = ks
            v_scales[:, page_ids, slot_ids] = vs
        k_pages[:, page_ids, slot_ids] = kt
        v_pages[:, page_ids, slot_ids] = vt.to(v_pages.dtype)

    # -- attention ----------------------------------------------------------
    def attend(self, layer, q, k, v):
        """Attention for one layer in the armed mode. ``q [b, s, heads,
        d]``, ``k``/``v [b, s, kv_heads, d]`` -> ``[b, s, heads, d]``. The
        pools take k's dtype, as the reference's (``generation.py:1183``):
        fp32 in a bf16 model, whose rope makes q and k fp32 (ROADMAP C25),
        so the serving kernels get fp32 q and pages there. Under AMP the
        decode step and the ragged tick are the reference's ops
        ``"paged_attention"`` and ``"ragged_paged_attention"`` (``:1435``,
        ``:1400``), which cast q alone: 16-bit q over the fp32 pages under
        O2 (ROADMAP C29)."""
        mode, arg = self._mode
        b, s, kv_heads, d = k.shape
        if mode != "prefill" and k.device != self.device:
            raise ValueError(f"the step's buffers are on {self.device}, the "
                             f"activations on {k.device}: pass the model's "
                             f"device to SlotPagedKVCache")
        k_pages, v_pages = self._pool(layer, kv_heads, d, k.dtype, k.device)
        if mode == "prefill":
            return self._attend_prefill(layer, arg, q, k, v, k_pages, v_pages)
        if mode == "decode":
            return self._attend_decode(layer, arg, q, k, v, k_pages, v_pages)
        return self._attend_ragged(layer, arg, q, k, v, k_pages, v_pages)

    def _attend_prefill(self, layer, slot, q, k, v, k_pages, v_pages):
        """One chunk of one slot: write its K/V into the pages, then attend
        densely through SDPA. With context already in the slot (a chunk
        after the first, or a prefix hit) the whole prefix is read back
        from the pages; table entries past the allocated blocks are the
        scratch page, whose keys sit past every real query's causal window
        and are seen only by pad queries. An int8 pool always reads back
        (reference ``:1219-1235``): every chunk, the first included,
        attends the quantised K/V the decode steps will see, k dequantised
        to k's dtype and v to v's."""
        b, s, kv_heads, d = k.shape
        if b != 1:
            raise ValueError("a prefill chunk holds one sequence")
        start = int(self.lens[slot])
        n_valid = s if self._prefill_valid is None \
            else min(self._prefill_valid, s)
        if start + n_valid > self.max_len:
            raise ValueError(f"slot overflow: {start}+{n_valid} > "
                             f"{self.max_len}")
        if self._idx is None:       # shared by every layer of the forward
            self._prefill_valid = n_valid          # what end_step advances
            self._ensure_blocks(slot, start + n_valid)
            for blk in range(start // self.page_size,
                             -(-(start + n_valid) // self.page_size)):
                self._make_writable(slot, blk)
            pos = np.arange(start, start + s)
            valid = pos < start + n_valid
            # a padded chunk may run past the table: pad positions write
            # to the scratch page
            blk_ids = np.minimum(pos // self.page_size,
                                 self.pages_per_seq - 1)
            page_ids = np.where(valid, self._tables[slot, blk_ids], 0)
            slot_ids = np.where(valid, pos % self.page_size, 0)
            n_pages = min(-(-(start + s) // self.page_size),
                          self.pages_per_seq)
            table = self._tables[slot, :n_pages].astype(np.int64)
            self._idx = tuple(torch.from_numpy(a.astype(np.int64)).to(
                k.device) for a in (page_ids, slot_ids, table))
        page_ids, slot_ids, table = self._idx
        self._scatter(layer, k_pages, v_pages, k[0].transpose(0, 1),
                      v[0].transpose(0, 1), page_ids, slot_ids)
        if start > 0 or self.kv_quant:
            ks, vs = self._layer_scales(layer)
            kf = _page_gather(k_pages, table, ks, k.dtype)
            vf = _page_gather(v_pages, table, vs, v.dtype)
            pad = start + s - kf.shape[0]
            if pad > 0:
                # the padded chunk ran past the table: zero keys past it
                # keep SDPA's bottom-right alignment, and only pad queries
                # see them
                kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
                vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
            k, v = kf[None, :start + s], vf[None, :start + s]
        return scaled_dot_product_attention(q, k, v, is_causal=True)

    def _attend_decode(self, layer, mask, q, k, v, k_pages, v_pages):
        """One token for every slot (fixed shape), each at its own
        position. Inactive slots write to the scratch page and read with
        ``ctx = 1``: a finite, discarded result."""
        b, s = k.shape[:2]
        if b != self.max_batch or s != 1:
            raise ValueError(f"a decode step is [{self.max_batch}, 1], got "
                             f"[{b}, {s}]")
        page_ids, slot_ids, tables, ctx = self._idx
        self._scatter(layer, k_pages, v_pages, k.permute(2, 0, 1, 3),
                      v.permute(2, 0, 1, 3), page_ids, slot_ids)
        ks, vs = self._layer_scales(layer)
        (q,) = amp.amp_cast_inputs("paged_attention", [q])
        return paged_attention(q[:, 0], k_pages, v_pages, tables, ctx,
                               k_scales=ks, v_scales=vs)[:, None]

    def _attend_ragged(self, layer, spans, q, k, v, k_pages, v_pages):
        """Scatter this tick's K/V, then read every span's whole context
        back from the pages through the ragged kernel."""
        b, s = k.shape[:2]
        if b != 1:
            raise ValueError("a ragged step packs one flat token batch")
        page_ids, slot_ids, tables, desc, plan = self._idx
        if page_ids.shape[0] != s:
            raise ValueError(f"a ragged step armed for {page_ids.shape[0]} "
                             f"tokens got {s}")
        self._scatter(layer, k_pages, v_pages, k[0].transpose(0, 1),
                      v[0].transpose(0, 1), page_ids, slot_ids)
        ks, vs = self._layer_scales(layer)
        (q,) = amp.amp_cast_inputs("ragged_paged_attention", [q])
        out = ragged_paged_attention(q[0], k_pages, v_pages, tables, *desc,
                                     impl=self.ragged_impl, plan=plan,
                                     k_scales=ks, v_scales=vs)
        return out[None]


def _step_generator(seed, step, device):
    """The generator of sampling step ``step`` under ``seed``: a function
    of the pair alone, so step ``i`` draws the same numbers whatever ran
    before it (the reference folds the step into its PRNG key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (1 << 63))
    return gen


def _row_generator(seed, row_idx, token_idx, device):
    """The generator of token ``token_idx`` of row ``row_idx`` of a
    request seeded with ``seed``: a function of the triple alone, so a
    seeded request draws the same numbers whatever it shares a tick with
    and whichever scheduler runs it (the counterpart of the reference
    engine's ``_row_key``, which folds the row and the token index into
    the request's PRNG key)."""
    return _step_generator(int(seed) * 1_000_003 + int(row_idx), token_idx,
                           device)


def _sample_logits(logits, do_sample, top_k, top_p, temperature,
                   generator=None):
    """``logits [b, V]`` (float) -> token ids ``[b]`` (int64).

    Greedy unless ``do_sample``; otherwise temperature, then top-k, then
    top-p (nucleus) filtering as the reference writes them
    (``generation.py:1449-1461``), then one categorical draw per row from
    ``generator`` (the global generator when ``None``)."""
    if not do_sample:
        return logits.argmax(-1)
    logits = logits / max(temperature, 1e-6)
    if top_k:
        kth = logits.sort(-1).values[:, -int(top_k)][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p and top_p < 1.0:
        sorted_l = logits.sort(-1, descending=True).values
        probs = torch.softmax(sorted_l, -1).cumsum(-1)
        cutoff = (probs < top_p).sum(-1).clamp_max(logits.shape[-1] - 1)
        kth = sorted_l.gather(-1, cutoff[:, None])
        logits = torch.where(logits < kth, float("-inf"), logits)
    return torch.multinomial(torch.softmax(logits, -1), 1,
                             generator=generator)[:, 0]


class GenerationMixin:
    """Adds ``generate`` to causal-LM modules whose forward accepts
    ``cache=`` (``supports_cache = True``); others recompute the whole
    sequence every step."""

    supports_cache = False

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, max_length=None,
                 do_sample=False, top_k=0, top_p=1.0, temperature=1.0,
                 eos_token_id=None, num_beams=1, length_penalty=1.0,
                 seed=None, cache=None, use_paged_cache=False, page_size=16):
        """Returns the ids ``[b, prompt + new]`` as an int64 tensor on the
        model's device, prompt included. ``max_length`` overrides
        ``max_new_tokens`` as the total length. ``use_paged_cache`` decodes
        over a :class:`PagedKVCache` of ``page_size`` pages (paged decode
        kernel) instead of the concat :class:`KVCache`. Rows that emit
        ``eos_token_id`` continue with it; generation stops once every
        row has. ``num_beams > 1`` runs beam search (greedy only).
        ``seed`` makes sampled decode reproducible: step ``i`` draws from
        a generator that depends on ``(seed, i)`` alone."""
        dev = next(self.parameters()).device
        ids = (input_ids.to(dev, torch.int64)
               if isinstance(input_ids, torch.Tensor)
               else torch.as_tensor(np.asarray(input_ids), dtype=torch.int64,
                                    device=dev))
        if ids.dim() == 1:
            ids = ids[None]
        if max_length is not None:
            max_new_tokens = max(int(max_length) - ids.shape[1], 0)
        if num_beams > 1:
            if do_sample:
                raise ValueError("beam search requires do_sample=False")
            return self._beam_search(ids, max_new_tokens, num_beams,
                                     eos_token_id, length_penalty)
        was_training = self.training
        self.eval()
        try:
            if cache is None and self.supports_cache:
                cache = (PagedKVCache(page_size=page_size,
                                      max_len=ids.shape[1] + max_new_tokens)
                         if use_paged_cache else KVCache())
            cur, all_ids = ids, ids
            finished = torch.zeros(ids.shape[0], dtype=torch.bool,
                                   device=dev)
            for step in range(max_new_tokens):
                logits = (self(cur, cache=cache) if cache is not None
                          else self(all_ids))
                gen = None if seed is None else _step_generator(seed, step,
                                                                dev)
                nxt = _sample_logits(logits[:, -1].float(), do_sample, top_k,
                                     top_p, temperature, gen)
                if eos_token_id is not None:
                    nxt = torch.where(finished, int(eos_token_id), nxt)
                    finished |= nxt == eos_token_id
                all_ids = torch.cat([all_ids, nxt[:, None]], dim=1)
                cur = nxt[:, None]
                if eos_token_id is not None and bool(finished.all()):
                    break
            return all_ids
        finally:
            if was_training:
                self.train()

    def _beam_search(self, ids, max_new_tokens, num_beams, eos_token_id,
                     length_penalty):
        """Batched beam search over the concat cache (a beam hop gathers
        whole rows, which paged pools owned per sequence cannot alias)."""
        was_training = self.training
        self.eval()
        try:
            dev = ids.device
            b = ids.shape[0]
            n = int(num_beams)
            all_ids = ids.repeat_interleave(n, dim=0)          # [b*n, s]
            cache = KVCache() if self.supports_cache else None
            # beam 0 carries the prompt; the others start dead so the
            # first step does not pick n copies of one continuation
            scores = torch.tensor([0.0] + [float("-inf")] * (n - 1),
                                  device=dev).repeat(b)        # [b*n]
            finished = torch.zeros(b * n, dtype=torch.bool, device=dev)
            lengths = torch.zeros(b * n, device=dev)
            cur = all_ids
            for step in range(max_new_tokens):
                logits = (self(cur, cache=cache) if cache is not None
                          else self(all_ids))
                lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
                vocab = lp.shape[-1]
                if eos_token_id is not None:
                    # a finished beam only continues with EOS, at no cost
                    frozen = torch.full((vocab,), float("-inf"), device=dev)
                    frozen[int(eos_token_id)] = 0.0
                    lp = torch.where(finished[:, None], frozen[None], lp)
                total = scores[:, None] + lp                   # [b*n, V]
                top_s, top_i = total.reshape(b, n * vocab).topk(n, dim=-1)
                parent = (top_i // vocab
                          + torch.arange(b, device=dev)[:, None] * n
                          ).reshape(-1)
                token = (top_i % vocab).reshape(-1)
                scores = top_s.reshape(-1)
                all_ids = torch.cat([all_ids[parent], token[:, None]], dim=1)
                # each hypothesis' length stops at the step EOS fired
                lengths = torch.where(finished[parent], lengths[parent],
                                      float(step + 1))
                finished = finished[parent]
                if eos_token_id is not None:
                    finished |= token == eos_token_id
                if cache is not None:
                    cache.reorder(parent)
                cur = token[:, None]
                if eos_token_id is not None and bool(finished.all()):
                    break
            norm = scores / lengths.clamp_min(1.0) ** float(length_penalty)
            best = norm.reshape(b, n).argmax(-1) \
                + torch.arange(b, device=dev) * n
            return all_ids[best]
        finally:
            if was_training:
                self.train()
