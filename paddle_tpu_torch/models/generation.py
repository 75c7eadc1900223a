"""Slot-paged KV cache for continuous batching (port of the native-page,
ragged-mode parts of ``paddle_tpu/models/generation.py``).

Every slot has its own context length and lifecycle over one shared,
refcounted page pool: a slot is **assigned** a prompt on admission
(leading full blocks that hit the hash-chained prefix index map onto
already-filled pages), runs **ragged** ticks that write its new tokens'
K/V and attend its whole context, and is **freed** on completion. Page 0
is a scratch page that is never allocated: padding tokens write there
and unused table entries point there. Writing into a shared page
(refcount > 1 or registered in the prefix index) copies it first.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np
import torch

from ..ops.ragged_paged_attention import make_plan, ragged_paged_attention


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


class SlotPagedKVCache:
    """Per-slot paged KV cache over a shared refcounted page pool.

    ``ragged_impl`` picks the attention grid: ``"qblock"`` (the default)
    or ``"token"`` (the per-token escape hatch)."""

    def __init__(self, max_batch, page_size=16, max_len=2048,
                 num_pages=None, enable_prefix_cache=True,
                 ragged_impl="qblock"):
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_seq = -(-self.max_len // self.page_size)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.ragged_impl = ragged_impl
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
        self._mode = None
        self._idx = None                  # per-forward index memo
        self.prefix_hits = 0              # full blocks served from the index
        self.prefix_misses = 0            # full blocks that had to prefill
        self.cow_copies = 0
        self.prefix_evictions_device = 0

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
        for kp, vp in self._pools.values():    # in place, every layer
            kp[:, new] = kp[:, page]
            vp[:, new] = vp[:, page]
        self._decref(page)
        self._tables[slot, blk] = new
        self.cow_copies += 1

    @property
    def free_page_count(self):
        return len(self._free)

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

    def begin_ragged(self, spans):
        """Arm the next forward as one ragged mixed prefill+decode step.
        ``spans`` lists ``(slot, q_start, n_new)``: the slot's next
        ``n_new`` context tokens sit at ``q_start`` of the flat
        ``[1, tokens]`` batch, ``q_start`` non-decreasing. Tokens outside
        every span are padding. Pages are allocated and copy-on-write
        resolved here, once per step."""
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
        self._idx = None

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
        # the engine always passes explicit per-token positions
        return 0

    def advance(self, s):
        mode, spans = self._mode
        if mode != "ragged":
            raise RuntimeError(f"advance in mode {mode!r}")
        for slot, _, n_new in spans:
            self.lens[slot] += n_new

    def _pool(self, layer, kv_heads, d, dtype, device):
        key = id(layer)
        if key not in self._pools:
            shape = (kv_heads, self.num_pages, self.page_size, d)
            self._pools[key] = (torch.zeros(shape, dtype=dtype, device=device),
                                torch.zeros(shape, dtype=dtype, device=device))
        return self._pools[key]

    @staticmethod
    def _scatter(k_pages, v_pages, kt, vt, page_ids, slot_ids):
        """Write this forward's K/V rows ``[kv, s, d]`` into the pages in
        place (``index_put_``). The reference returns new pools from a
        functional ``.at[].set``; PyTorch can update the pool it holds,
        which saves a copy of every layer's pool per tick."""
        k_pages[:, page_ids, slot_ids] = kt
        v_pages[:, page_ids, slot_ids] = vt

    # -- attention ----------------------------------------------------------
    def attend(self, layer, q, k, v):
        """Ragged attention for one layer: scatter this tick's K/V, then
        read every span's whole context back from the pages. ``q [1, s,
        heads, d]``, ``k``/``v [1, s, kv_heads, d]`` -> ``[1, s, heads,
        d]``."""
        mode, spans = self._mode
        if mode != "ragged":
            raise RuntimeError(f"attend in mode {mode!r}")
        b, s, kv_heads, d = k.shape
        if b != 1:
            raise ValueError("a ragged step packs one flat token batch")
        k_pages, v_pages = self._pool(layer, kv_heads, d, k.dtype, k.device)
        if self._idx is None:       # shared by every layer of the forward
            page_ids = np.zeros(s, np.int64)     # default: scratch page
            slot_ids = np.zeros(s, np.int64)
            for slot, qs, n_new in spans:
                pos = np.arange(self.lens[slot], self.lens[slot] + n_new)
                page_ids[qs:qs + n_new] = \
                    self._tables[slot, pos // self.page_size]
                slot_ids[qs:qs + n_new] = pos % self.page_size
            desc = (np.asarray([sl for sl, _, _ in spans], np.int32),
                    np.asarray([qs for _, qs, _ in spans], np.int32),
                    np.asarray([n for _, _, n in spans], np.int32),
                    np.asarray([int(self.lens[sl]) + n
                                for sl, _, n in spans], np.int32))
            tables = self._tables.copy()
            plan = make_plan(s, *desc, tables, self.page_size,
                             impl=self.ragged_impl, device=k.device)
            self._idx = (torch.from_numpy(page_ids).to(k.device),
                         torch.from_numpy(slot_ids).to(k.device),
                         tables, desc, plan)
        page_ids, slot_ids, tables, desc, plan = self._idx
        self._scatter(k_pages, v_pages, k[0].transpose(0, 1),
                      v[0].transpose(0, 1), page_ids, slot_ids)
        out = ragged_paged_attention(q[0], k_pages, v_pages, tables, *desc,
                                     impl=self.ragged_impl, plan=plan)
        return out[None]
