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
* :class:`HostKVPool`: a host-RAM tier under a slot cache's prefix index,
  bounded in bytes with its own LRU.
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
  them. Evicted prefix pages may drop to a :class:`HostKVPool` and come
  back; ``export_pages`` / ``import_pages`` hand a prefix chain to another
  cache; a long prompt can be prefilled in stripes kept outside the pool
  (``assign_sep``), attended by the ring schedule.
* :class:`GenerationMixin`: ``generate`` (greedy, seeded sampling, beam
  search) for a causal LM whose forward takes ``cache=``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import amp
from ..framework import random as prandom
from ..nn.functional import scaled_dot_product_attention
from ..ops.paged_attention import paged_attention
from ..ops.ragged_paged_attention import (DEFAULT_QBLOCK, RaggedPlan,
                                          plan_arrays,
                                          ragged_paged_attention)
from ..ops.ring_attention import blockwise_causal_attention

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


def _dtype_name(t):
    """A tensor's or array's dtype as the reference names it (numpy's
    name: ``"float32"``, ``"int8"``, ``"bfloat16"``)."""
    return str(t.dtype).replace("torch.", "")


def _to_host(tensors):
    """Copies of same-shaped device tensors on the host, in one transfer:
    numpy arrays, or CPU tensors for a dtype numpy lacks (bf16)."""
    if not tensors:
        return []
    host = torch.stack(tensors).cpu()
    if host.dtype != torch.bfloat16:
        host = host.numpy()
    return list(host)


def _to_device(a, like):
    """Host array or tensor ``a`` on ``like``'s device."""
    return torch.as_tensor(a).to(like.device)


def _stack(parts, axis):
    """``np.stack`` of host arrays, or ``torch.stack`` of CPU tensors."""
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, axis)
    return np.stack(parts, axis)


class HostKVPool:
    """Host-RAM second tier under the prefix index (reference
    ``generation.py:83-177``). A prefix page that the device LRU evicts is
    demoted here as one single-page entry in the
    :meth:`SlotPagedKVCache.export_pages` layout (``{"page_size",
    "kv_dtype", "native_dtype", "layers": [(k, v) per layer], "scales":
    [(k, v) per layer] or None}``, each ``[kv, page_size, d]`` on the
    host; int8 pools demote their codes and fp32 row scales as they are),
    and an admission that misses the device index promotes it back, so
    the roundtrip is bit-exact.

    ``max_mb`` bounds the bytes held (0: the tier is off, eviction is the
    legacy one). Past the bound the least recently touched entries drop
    out (a second-level LRU). The pool does not depend on a cache: the
    serving engine owns one across cache rebuilds and hands it to every
    cache it builds. Counters: ``demotions`` (accepted puts),
    ``promotions`` (takes that moved a page back), ``hits`` and
    ``misses`` (lookups), ``evictions`` (second-level drops)."""

    def __init__(self, max_mb=0):
        self.max_bytes = int(float(max_mb) * 2 ** 20)
        self._entries = OrderedDict()     # digest -> entry (LRU order)
        self.used_bytes = 0
        self.demotions = 0
        self.promotions = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def enabled(self):
        return self.max_bytes > 0

    def __len__(self):
        return len(self._entries)

    def __contains__(self, digest):
        return bytes(digest) in self._entries

    @staticmethod
    def entry_nbytes(entry):
        total = sum(k.nbytes + v.nbytes for k, v in entry["layers"])
        if entry.get("scales"):
            total += sum(ks.nbytes + vs.nbytes
                         for ks, vs in entry["scales"])
        return total

    def put(self, digest, entry):
        """Admit a demoted page under ``digest``, then drop LRU entries
        until the byte bound holds (an entry larger than the whole pool is
        admitted and dropped at once). Returns True when the entry is
        resident after the call."""
        if not self.enabled:
            return False
        digest = bytes(digest)
        old = self._entries.pop(digest, None)
        if old is not None:
            self.used_bytes -= self.entry_nbytes(old)
        self._entries[digest] = entry
        self.used_bytes += self.entry_nbytes(entry)
        self.demotions += 1
        while self.used_bytes > self.max_bytes and self._entries:
            _, dropped = self._entries.popitem(last=False)
            self.used_bytes -= self.entry_nbytes(dropped)
            self.evictions += 1
        return digest in self._entries

    def get(self, digest):
        """Look an entry up (an LRU touch; it stays resident)."""
        entry = self._entries.get(bytes(digest))
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(bytes(digest))
        self.hits += 1
        return entry

    def take(self, digest):
        """Remove and return the entry (promotion: the device index holds
        the page again, and a later eviction demotes it again)."""
        entry = self._entries.pop(bytes(digest), None)
        if entry is not None:
            self.used_bytes -= self.entry_nbytes(entry)
        return entry

    def clear(self):
        self._entries.clear()
        self.used_bytes = 0


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


def dropout_generator(dropout_p, training, device):
    """The port's generator of ``device`` where attention dropout is
    active, else None."""
    return prandom.generator(device) if dropout_p and training else None


def _no_dropout(cache, training, dropout_p):
    """A paged cache serves: attention dropout while training raises, as
    in the reference's ``PagedKVCache.attend`` (``generation.py:294``)."""
    if dropout_p and training:
        raise ValueError(f"{cache} is a serving cache: attention dropout "
                         f"is not supported")


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

    def attend(self, layer, q, k, v, training=False, dropout_p=0.0):
        """Update the store with this step's K/V and attend over all of it:
        ``q [b, s, heads, d]`` -> ``[b, s, heads, d]``. q, k and v keep
        their dtypes, as the reference's store does: in a bf16 model the
        rope makes q and k fp32 (ROADMAP C24) and v stays bf16, and SDPA
        computes the mix in fp32. ``training`` and ``dropout_p`` go to
        SDPA, as in the reference (``generation.py:214``); the dropout
        draws from the port's generator of the device."""
        k, v = self.update(layer, k, v)
        return scaled_dot_product_attention(
            q, k, v, dropout_p=dropout_p, is_causal=True, training=training,
            generator=dropout_generator(dropout_p, training, q.device))


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

    def attend(self, layer, q, k, v, training=False, dropout_p=0.0):
        """The pools take k's dtype, as the reference's (``generation.py:
        303``): fp32 in a bf16 model, whose rope makes k fp32 (ROADMAP
        C25), under AMP too; v is cast to it where it is written. A decode
        step is the reference's op ``"paged_attention"`` (``:354``), whose
        one tensor argument is q: AMP casts q alone, to 16 bits under O2
        (ROADMAP C29), and the output takes q's dtype. A serving cache
        takes no attention dropout: ``dropout_p`` while ``training``
        raises ``ValueError``, as the reference's does (``:290-296``)."""
        _no_dropout(type(self).__name__, training, dropout_p)
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
        # the kernel takes a dense q; GPT's is a slice of its fused
        # projection
        (q,) = amp.amp_cast_inputs("paged_attention", [q])
        return paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                               tables, ctx)[:, None]


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
    nothing of it.

    Tiered KV: ``host_pool`` (a :class:`HostKVPool`; ``None`` builds one
    that is off) catches the prefix pages the device LRU evicts
    (``host_demotions``), and :meth:`assign` promotes a block that misses
    the device index but is held there back onto a device page
    (``host_promotions``; entries of another geometry or dtype are
    dropped, ``host_promote_rejects``). :meth:`export_pages` and
    :meth:`import_pages` hand a prefix chain from one cache to another
    (prefill-to-decode disaggregation); pages imported before the first
    forward wait in a backlog that each layer's pool applies as it is
    made. Every write of a promoted, imported or copied page goes into
    the existing pools in place, so graphs captured over them stay
    valid, and it happens in ``assign``, ``begin_*`` or the import, never
    inside a captured forward.

    Long context: :meth:`assign_sep` arms a slot for striped prefill
    (``allow_page_overcommit=True`` lets the pool be smaller than one
    sequence). The prompt is prefilled in fixed chunks of
    ``stripe_tokens`` (:meth:`begin_sep_prefill`); a full chunk's K/V
    becomes a stripe kept outside the page pool, and only the trailing
    partial chunk and the decode tail (:meth:`begin_sep_decode`) take
    device pages. Attention runs the ring schedule block by block
    (:func:`~paddle_tpu_torch.ops.ring_attention.blockwise_causal_attention`
    over B1): every stripe, then the chunk itself or the tail window.
    The reference keeps stripes as host arrays and uploads each one at
    every forward (``generation.py:1269``, ``:1292``); here they stay
    device tensors beside the pool (about 262 KB a token at Llama-3-8B's
    widths in fp32), which is placement only: the page pool still holds
    the tail alone. :meth:`export_stripes` copies them to numpy."""

    def __init__(self, max_batch, page_size=16, max_len=2048,
                 num_pages=None, enable_prefix_cache=True,
                 ragged_impl="qblock", kv_dtype=None, device=None,
                 host_pool=None, allow_page_overcommit=False):
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
        if allow_page_overcommit:
            # long-context serving: stripes hold the bulk of a long
            # prompt, only the decode tail needs device pages
            if self.num_pages < 2:
                raise ValueError("num_pages must be >= 2")
        elif self.num_pages < self.pages_per_seq + 1:
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
        self.cached_tokens_total = 0
        self.cow_copies = 0
        # pages imported before the first forward: (page, K/V per layer,
        # scales per layer), landed as each layer's pool is made (pool
        # order = forward order = export order)
        self._import_backlog = []
        self.pages_imported = 0
        self.pages_exported = 0
        # speculative decoding's rejections (rollback())
        self.rollbacks = 0
        self.tokens_rolled_back = 0
        # the host tier under the prefix index
        self.host_pool = host_pool if host_pool is not None else HostKVPool()
        self.prefix_evictions_device = 0  # device-index LRU evictions
        self.host_demotions = 0           # evictions the tier caught
        self.host_promotions = 0          # host hits moved back to device
        self.host_promote_rejects = 0     # geometry or dtype mismatches
        # striped long-context prefill, per slot
        self._sep = [None] * self.max_batch
        self._sep_pending = None          # the chunk's K/V per layer
        self._sep_layer_i = 0             # forward-order layer cursor
        self.sep_stripes_stored = 0
        self.sep_chunks = 0
        self.sep_decode_steps = 0

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
        no live slot maps (refcount 1 == the index's own ref). With the
        host tier on, the page is demoted there first."""
        for digest in list(self._index):
            page = self._index[digest]
            if self._ref[page] == 1:
                self._demote(digest, page)
                del self._index[digest]
                del self._page_digest[page]
                self._ref[page] = 0
                self._free.append(page)
                self.prefix_evictions_device += 1
                return True
        return False

    def _page_entry(self, page):
        """One page as a host entry in the :meth:`export_pages` layout:
        ``[kv, page_size, d]`` K and V per layer (pool order), and the int8
        row scales ``[kv, page_size]``; one device-to-host copy each."""
        flat = _to_host([t[:, page] for pair in self._pools.values()
                         for t in pair])
        layers = list(zip(flat[0::2], flat[1::2]))
        scales = None
        if self.kv_quant:
            flat = _to_host([t[:, page] for pair in self._scales.values()
                             for t in pair])
            scales = list(zip(flat[0::2], flat[1::2]))
        return {"page_size": self.page_size, "kv_dtype": self.kv_dtype,
                "native_dtype": _dtype_name(layers[0][0]),
                "layers": layers, "scales": scales}

    @torch.inference_mode()
    def _land(self, page, per_layer, per_scales, first_layer=0):
        """Write one page's host K/V (and int8 row scales), one pair a
        layer from ``first_layer`` on in pool order, into the pools in
        place (under inference mode, as pools an engine's serve thread
        made are inference tensors)."""
        for key, (kb, vb) in zip(list(self._pools)[first_layer:], per_layer):
            kp, vp = self._pools[key]
            kp[:, page] = _to_device(kb, kp)
            vp[:, page] = _to_device(vb, vp)
        if self.kv_quant and per_scales is not None:
            for key, (ksb, vsb) in zip(list(self._scales)[first_layer:],
                                       per_scales):
                ks, vs = self._scales[key]
                ks[:, page] = _to_device(ksb, ks)
                vs[:, page] = _to_device(vsb, vs)

    def _pool_dtype_name(self):
        return _dtype_name(next(iter(self._pools.values()))[0])

    def _demote(self, digest, page):
        """The eviction hook: copy the page into the host tier (nothing
        when the tier is off, or before the first forward made the
        pools)."""
        hp = self.host_pool
        if not hp.enabled or not self._pools:
            return False
        if hp.put(bytes(digest), self._page_entry(int(page))):
            self.host_demotions += 1
            return True
        return False

    def _promote(self, digest):
        """The admission hook: move a host entry back onto a device page
        and register it in the prefix index (the index's own ref). Returns
        the page, or None on a miss, on a mismatch (the entry is dropped)
        or when the device pool is exhausted (the entry goes back to the
        host so that a later admission can retry)."""
        hp = self.host_pool
        if not hp.enabled:
            return None
        entry = hp.get(bytes(digest))
        if entry is None:
            return None
        ok = (int(entry["page_size"]) == self.page_size
              and entry["kv_dtype"] == self.kv_dtype)
        if ok and self._pools:
            ok = (entry["native_dtype"] == self._pool_dtype_name()
                  and len(entry["layers"]) == len(self._pools))
        if not ok:
            # an entry of another configuration cannot land bit-exactly
            hp.take(bytes(digest))
            self.host_promote_rejects += 1
            return None
        entry = hp.take(bytes(digest))
        try:
            # may evict (and demote) colder digests; this entry is off
            # the host LRU already, so it cannot be one of them
            page = self._alloc_page()
        except RuntimeError:
            hp.put(bytes(digest), entry)
            return None
        if self._pools:
            self._land(page, entry["layers"], entry["scales"])
        else:
            self._import_backlog.append((page, entry["layers"],
                                         entry["scales"]))
        self._index[bytes(digest)] = page     # MRU end, ref 1 = the index's
        self._page_digest[page] = bytes(digest)
        self.host_promotions += 1
        hp.promotions += 1
        return page

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
            if page is not None:
                self._index.move_to_end(chain[i])  # LRU touch
            else:
                # a device miss may sit in the host tier: promote it
                page = self._promote(chain[i])
            if page is None:
                break
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
        self.cached_tokens_total += cached
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
        prefill chunk by its real tokens; a full sep chunk also becomes
        the slot's next stripe)."""
        self.advance(self._prefill_valid
                     if self._mode[0] in ("prefill", "sep_prefill") else 0)

    def free(self, slot):
        slot = int(slot)
        # a sep slot maps no page below its tail: those entries stay 0,
        # which _decref skips
        self._sep[slot] = None
        for i in range(int(self._n_blocks[slot])):
            self._decref(self._tables[slot, i])
        self._tables[slot, :] = 0
        self._n_blocks[slot] = 0
        self.lens[slot] = 0
        self._chain[slot] = None

    # -- prefill-to-decode handoff -------------------------------------------
    def export_pages(self, digests):
        """The handoff payload of the prefix-index pages behind the
        leading run of ``digests`` (a :func:`block_hash_chain`): None when
        the first digest is not held, else ``{"page_size", "digests"
        (those exported), "layers": [(k, v) per layer, each [kv, blocks,
        page_size, d] on the host], "kv_dtype", "native_dtype", "scales"
        (int8 pools: their fp32 row scales, the codes going as they are),
        "host_pages"}``. A digest the device index misses is read from
        the host tier, without promotion (``host_pages`` counts those).
        Layer order is pool order, which is forward order. The
        reference's ``ledger_digest`` field, set while its determinism
        ledger is on, is not written: the port has no ledger yet."""
        srcs, out_digests, host_pages = [], [], 0
        hp = self.host_pool
        for d in digests:
            page = self._index.get(d)
            if page is not None:
                if not self._pools:
                    break                  # no device K/V made yet
                self._index.move_to_end(d)             # LRU touch
                srcs.append((len(self._pools), int(page)))
            else:
                he = hp.get(bytes(d)) if hp.enabled else None
                if (he is None or int(he["page_size"]) != self.page_size
                        or he["kv_dtype"] != self.kv_dtype
                        or (srcs and len(he["layers"]) != srcs[0][0])):
                    break
                srcs.append((len(he["layers"]), he))
                host_pages += 1
            out_digests.append(bytes(d))
        if not srcs:
            return None
        n_layers = srcs[0][0]
        if any(n != n_layers for n, _ in srcs):
            return None
        dev_pages = [src for _, src in srcs if isinstance(src, int)]

        def gather(pools, key):
            """Per layer, K and V with the blocks on axis 1: the device
            pages in one transfer, host entries from their ``key``."""
            flat = iter(_to_host([t[:, dev_pages] for pair in pools
                                  for t in pair]) if dev_pages else [])
            dev = list(zip(flat, flat))        # per layer: [kv, n, P, d]
            out = []
            for li in range(n_layers):
                parts, j = [], 0
                for _, src in srcs:
                    if isinstance(src, int):
                        parts.append((dev[li][0][:, j], dev[li][1][:, j]))
                        j += 1
                    else:
                        parts.append(src[key][li])
                out.append(tuple(_stack([p[i] for p in parts], 1)
                                 for i in (0, 1)))
            return out

        layers = gather(list(self._pools.values()), "layers")
        scales = (gather(list(self._scales.values()), "scales")
                  if self.kv_quant else None)
        self.pages_exported += len(srcs)
        return {"page_size": self.page_size, "digests": out_digests,
                "layers": layers, "kv_dtype": self.kv_dtype,
                "native_dtype": _dtype_name(layers[0][0]), "scales": scales,
                "host_pages": host_pages}

    def import_pages(self, blob):
        """The receiving side of the handoff: allocate a page for each
        exported block not already held, write its K/V into the pools in
        place (or into the backlog before the first forward), and register
        the digests in the prefix index with the index's own ref, as
        :meth:`commit_prefix` does, so the next :meth:`assign` of a prompt
        on that chain maps onto them. Raises on another page size, KV
        dtype, pool dtype or layer count. Returns the pages imported."""
        if not blob or not self.enable_prefix_cache:
            return 0
        if int(blob["page_size"]) != self.page_size:
            raise ValueError(
                f"page_size mismatch: exporter {blob['page_size']} vs "
                f"importer {self.page_size}")
        blob_kv = blob.get("kv_dtype", "native")
        if blob_kv != self.kv_dtype:
            # an int8 blob in a native pool (or the reverse) would be
            # requantised without a word: refuse
            raise ValueError(f"kv_dtype mismatch: exporter {blob_kv} vs "
                             f"importer {self.kv_dtype}")
        if self._pools:
            pool_dtype = self._pool_dtype_name()
            blob_native = blob.get("native_dtype", pool_dtype)
            if blob_native != pool_dtype:
                raise ValueError(
                    f"pool dtype mismatch: exporter {blob_native} vs "
                    f"importer {pool_dtype}")
            if len(blob["layers"]) != len(self._pools):
                raise ValueError(
                    f"layer count mismatch: exporter {len(blob['layers'])} "
                    f"vs importer {len(self._pools)}")
        blob_scales = blob.get("scales")
        imported = 0
        for j, digest in enumerate(blob["digests"]):
            if digest in self._index:
                continue
            page = self._alloc_page()        # ref 1: the index's own
            per_layer = [(k[:, j], v[:, j]) for k, v in blob["layers"]]
            per_scales = ([(ks[:, j], vs[:, j]) for ks, vs in blob_scales]
                          if blob_scales is not None else None)
            if self._pools:
                self._land(page, per_layer, per_scales)
            else:
                self._import_backlog.append((page, per_layer, per_scales))
            self._index[digest] = page
            self._page_digest[page] = digest
            imported += 1
        self.pages_imported += imported
        return imported

    # -- striped long-context prefill ----------------------------------------
    def assign_sep(self, slot, prompt_tokens, stripe_tokens):
        """Arm ``slot`` for striped long-context serving: the prompt is
        prefilled in chunks of ``stripe_tokens`` whose K/V become stripes
        (in ring order: stripe ``i`` is what replica ``i % sep_ways``
        would hold, :meth:`export_stripes`), not device pages, so a
        prompt far larger than the page pool serves. Only the trailing
        partial chunk and the decode tail take device pages. No prefix
        index: a stripe is not page-granular. Returns the number of
        chunks."""
        slot = int(slot)
        self.free(slot)
        n = int(prompt_tokens)
        stripe = int(stripe_tokens)
        if stripe <= 0 or stripe % self.page_size:
            raise ValueError(f"stripe_tokens {stripe} must be a positive "
                             f"multiple of page_size {self.page_size}")
        if self.kv_quant:
            raise ValueError("sep prefill requires native KV pages "
                             "(kv_dtype='int8' is unsupported)")
        if n > self.max_len:
            raise ValueError(f"prompt {n} > max_len {self.max_len}")
        self._sep[slot] = {"stripe": stripe, "base": 0, "len": n,
                           "stripes": []}
        return -(-n // stripe)

    def begin_sep_prefill(self, slot, n_valid=None):
        """Arm the next forward as one sep chunk of ``slot``, padded to the
        stripe length (``n_valid`` real tokens in the trailing partial
        chunk)."""
        slot = int(slot)
        if self._sep[slot] is None:
            raise RuntimeError(f"slot {slot} is not sep-assigned")
        self._mode = ("sep_prefill", slot)
        self._idx = None
        self._prefill_valid = None if n_valid is None else int(n_valid)
        self._sep_pending = []
        self._sep_layer_i = 0
        self.sep_chunks += 1

    def begin_sep_decode(self, slot):
        """Arm the next forward as one ``[1, 1]`` decode step of a sep
        slot: its K/V goes to a device tail page, and attention reads the
        stripes and the tail. Pages are allocated here, outside the
        forward."""
        slot = int(slot)
        sep = self._sep[slot]
        if sep is None:
            raise RuntimeError(f"slot {slot} is not sep-assigned")
        self._mode = ("sep_decode", slot)
        self._idx = None
        self._sep_layer_i = 0
        blk0 = sep["base"] // self.page_size
        if int(self._n_blocks[slot]) < blk0:
            # the stripes cover the blocks below the tail: allocate from
            # the tail's first block on
            self._n_blocks[slot] = blk0
        self._ensure_blocks(slot, int(self.lens[slot]) + 1)
        self._make_writable(slot, int(self.lens[slot]) // self.page_size)
        self.sep_decode_steps += 1

    def export_stripes(self, slot, sep_ways=1):
        """The striped handoff payload of a live sep slot, on the host
        (numpy): each stripe's K/V per layer (``[kv, stripe, d]``) tagged
        with its home on a ring of ``sep_ways`` replicas (``i %
        sep_ways``), and the decode tail ``[base, pos)`` as raw ``[kv,
        n_tail, d]`` rows per layer so that the importer resumes mid-span.
        None for a slot that is not sep-assigned."""
        slot = int(slot)
        sep = self._sep[slot]
        if sep is None:
            return None
        ways = max(int(sep_ways), 1)
        stripes = []
        for j, st in enumerate(sep["stripes"]):
            flat = iter(_to_host([t for pair in st for t in pair]))
            stripes.append({"home": j % ways, "layers": list(zip(flat,
                                                                 flat))})
        native = _dtype_name(stripes[0]["layers"][0][0]) if stripes else None
        base, pos = int(sep["base"]), int(self.lens[slot])
        tail = None
        if pos > base and self._pools:
            blk0 = base // self.page_size
            n_pages = -(-(pos - base) // self.page_size)
            tb = torch.as_tensor(
                self._tables[slot, blk0:blk0 + n_pages].astype(np.int64))
            flat = iter(_to_host([
                t[:, tb.to(t.device)].reshape(t.shape[0], -1,
                                              t.shape[-1])[:, :pos - base]
                for pair in self._pools.values() for t in pair]))
            tail = list(zip(flat, flat))
        return {"page_size": self.page_size, "stripe": sep["stripe"],
                "base": base, "len": int(sep["len"]), "pos": pos,
                "native_dtype": native, "sep_ways": ways,
                "stripes": stripes, "tail": tail}

    def import_stripes(self, slot, blob):
        """The receiving side of a striped handoff: arm ``slot`` with the
        exported stripes (on this cache's device) and resume at the
        exporter's position, prefilling on from ``pos`` or decoding if the
        span is complete; the tail rows land in fresh tail pages. Returns
        the number of stripes imported."""
        slot = int(slot)
        if not blob:
            return 0
        if int(blob["page_size"]) != self.page_size:
            raise ValueError(
                f"page_size mismatch: exporter {blob['page_size']} vs "
                f"importer {self.page_size}")
        stripe = int(blob["stripe"])
        if self.kv_quant:
            raise ValueError("sep stripes require a native KV pool")
        if self._pools and blob.get("native_dtype"):
            pool_dtype = self._pool_dtype_name()
            if blob["native_dtype"] != pool_dtype:
                raise ValueError(
                    f"pool dtype mismatch: exporter "
                    f"{blob['native_dtype']} vs importer {pool_dtype}")
        base, pos = int(blob["base"]), int(blob["pos"])
        tail = blob.get("tail")
        if pos > base and tail is None:
            raise ValueError("striped blob resumes mid-span but carries "
                             "no tail rows")
        if tail is not None and not self._pools:
            # tail rows land in the per-layer pools; stripes alone
            # (pos == base) import anywhere
            raise ValueError("import_stripes needs materialized pools "
                             "to land a mid-span tail")
        if tail is not None and len(tail) != len(self._pools):
            raise ValueError(f"layer count mismatch: exporter "
                             f"{len(tail)} vs importer {len(self._pools)}")
        self.free(slot)
        self._sep[slot] = {
            "stripe": stripe, "base": base, "len": int(blob["len"]),
            "stripes": [[(torch.as_tensor(k).to(self.device),
                          torch.as_tensor(v).to(self.device))
                         for k, v in st["layers"]]
                        for st in blob["stripes"]]}
        self.lens[slot] = pos
        if tail is not None:
            self._land_tail(slot, base, pos, tail)
        self.sep_stripes_stored += len(blob["stripes"])
        return len(blob["stripes"])

    @torch.inference_mode()
    def _land_tail(self, slot, base, pos, tail):
        """Tail rows ``[base, pos)`` of every layer into fresh pages of
        ``slot``, whole pages zero past the tail, in place."""
        blk0 = base // self.page_size
        self._n_blocks[slot] = blk0
        self._ensure_blocks(slot, pos)
        n_pages = -(-(pos - base) // self.page_size)
        tb = torch.as_tensor(
            self._tables[slot, blk0:blk0 + n_pages].astype(np.int64))
        for (kb, vb), (kp, vp) in zip(tail, self._pools.values()):
            for rows, pool in ((kb, kp), (vb, vp)):
                # whole pages, zero past the tail, written in place
                padded = pool.new_zeros((pool.shape[0],
                                         n_pages * self.page_size,
                                         pool.shape[-1]))
                padded[:, :pos - base] = _to_device(rows, pool)
                pool[:, tb.to(pool.device)] = padded.reshape(
                    pool.shape[0], n_pages, self.page_size, -1)

    def sep_view(self, slot):
        """A sep slot's shape-relevant state: the stripe count, the
        power-of-two tail-page window the next decode step reads, its
        base and the admitted span. None for another slot."""
        sep = self._sep[int(slot)]
        if sep is None:
            return None
        n_tail = int(self.lens[slot]) + 1 - sep["base"]
        n_tp = -(-max(n_tail, 1) // self.page_size)
        return {"stripes": len(sep["stripes"]),
                "tail_pages": 1 << max(n_tp - 1, 0).bit_length(),
                "base": int(sep["base"]), "len": int(sep["len"])}

    @property
    def pos(self):
        # a prefill chunk starts at its slot's length; the engines pass
        # explicit per-token positions for the other modes
        if self._mode and self._mode[0] in ("prefill", "sep_prefill"):
            return int(self.lens[self._mode[1]])
        return 0

    def advance(self, s):
        """Advance the lengths by the armed step: a prefill chunk (or sep
        chunk) of ``s`` tokens by ``s`` (at most its ``n_valid``), every
        decode row or ragged span by its own tokens; a full sep chunk's
        K/V becomes the slot's next stripe and its base moves on."""
        mode, arg = self._mode
        if mode == "prefill":
            n = self._prefill_valid
            self.lens[arg] += int(s) if n is None else min(int(s), n)
        elif mode == "sep_prefill":
            sep = self._sep[arg]
            n = self._prefill_valid
            n = int(s) if n is None else min(int(s), n)
            if self._sep_pending:
                # a full chunk becomes the next stripe of the ring
                sep["stripes"].append(list(self._sep_pending))
                sep["base"] += sep["stripe"]
                self.sep_stripes_stored += 1
            self._sep_pending = None
            self.lens[arg] += n
        elif mode == "ragged":
            for slot, _, n_new in arg:
                self.lens[slot] += n_new
        else:                  # the decode mask, or a sep decode's slot
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
            # land the pages imported (or promoted) before the first
            # forward, this layer's part; pages evicted since are dead
            li = len(self._pools) - 1
            for page, per_layer, per_scales in self._import_backlog:
                if li < len(per_layer) and page in self._page_digest:
                    self._land(page, per_layer[li:li + 1],
                               per_scales[li:li + 1] if per_scales
                               else None, first_layer=li)
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
    def attend(self, layer, q, k, v, training=False, dropout_p=0.0):
        """Attention for one layer in the armed mode. ``q [b, s, heads,
        d]``, ``k``/``v [b, s, kv_heads, d]`` -> ``[b, s, heads, d]``. The
        pools take k's dtype, as the reference's (``generation.py:1183``):
        fp32 in a bf16 model, whose rope makes q and k fp32 (ROADMAP C25),
        so the serving kernels get fp32 q and pages there. Under AMP the
        decode step and the ragged tick are the reference's ops
        ``"paged_attention"`` and ``"ragged_paged_attention"`` (``:1435``,
        ``:1400``), which cast q alone: 16-bit q over the fp32 pages under
        O2 (ROADMAP C29). As in :class:`PagedKVCache`, ``dropout_p``
        while ``training`` raises ``ValueError``."""
        _no_dropout(type(self).__name__, training, dropout_p)
        mode, arg = self._mode
        b, s, kv_heads, d = k.shape
        if mode != "prefill" and k.device != self.device:
            raise ValueError(f"the step's buffers are on {self.device}, the "
                             f"activations on {k.device}: pass the model's "
                             f"device to SlotPagedKVCache")
        k_pages, v_pages = self._pool(layer, kv_heads, d, k.dtype, k.device)
        if mode == "prefill":
            return self._attend_prefill(layer, arg, q, k, v, k_pages, v_pages)
        if mode in ("sep_prefill", "sep_decode"):
            return self._attend_sep(layer, mode, arg, q, k, v, k_pages,
                                    v_pages)
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

    def _attend_sep(self, layer, mode, slot, q, k, v, k_pages, v_pages):
        """Long-context attention of one sep slot (reference
        ``:1257-1353``): the ring schedule block by block, every stripe of
        this layer first (stripe ``j`` at ``j * stripe``), then, for a
        chunk, the chunk itself at its start (its pad keys sit past every
        real query), or, for a decode token, the power-of-two window of
        tail pages from the base (entries past the allocated tail are the
        scratch page, whose positions lie past the query). A full chunk's
        K/V, v cast to the pool's dtype as the pages hold it, waits for
        :meth:`advance` to become a stripe; a trailing partial chunk and
        each decode token are scattered into tail pages. The op is the
        reference's ``"sep_ring_attention"``, whose one tensor argument
        is q: under ``auto_cast`` O2 q alone goes to 16 bits, and every
        B1 partial runs in fp32 on the upcast q
        (:func:`~paddle_tpu_torch.ops.ring_attention.ring_partial`)."""
        b, s, kv_heads, d = k.shape
        if b != 1:
            raise ValueError("sep serving admits one request at a time")
        sep = self._sep[slot]
        stripe = sep["stripe"]
        li = self._sep_layer_i            # forward-order stripe index
        self._sep_layer_i += 1
        blocks = [(st[li][0][None], st[li][1][None], j * stripe)
                  for j, st in enumerate(sep["stripes"])]
        kt, vt = k[0].transpose(0, 1), v[0].transpose(0, 1)   # [kv, s, d]
        if mode == "sep_prefill":
            if s != stripe:
                raise ValueError(f"sep chunk must be padded to the stripe "
                                 f"length: got {s}, expected {stripe}")
            start = int(self.lens[slot])            # == sep["base"]
            n_valid = s if self._prefill_valid is None \
                else min(self._prefill_valid, s)
            if start + n_valid > self.max_len:
                raise ValueError(f"slot overflow: {start}+{n_valid} > "
                                 f"{self.max_len}")
            blocks.append((k.transpose(1, 2), v.transpose(1, 2), start))
            if n_valid == s:
                self._sep_pending.append(
                    (kt.contiguous(), vt.to(k_pages.dtype).contiguous()))
            else:
                if self._idx is None:     # shared by every layer
                    blk0 = start // self.page_size
                    if int(self._n_blocks[slot]) < blk0:
                        self._n_blocks[slot] = blk0
                    self._ensure_blocks(slot, start + n_valid)
                    pos = np.arange(start, start + s)
                    valid = pos < start + n_valid
                    blk_ids = np.minimum(pos // self.page_size,
                                         self.pages_per_seq - 1)
                    self._idx = tuple(torch.from_numpy(a.astype(
                        np.int64)).to(k.device) for a in (
                            np.where(valid, self._tables[slot, blk_ids], 0),
                            np.where(valid, pos % self.page_size, 0)))
                self._scatter(layer, k_pages, v_pages, kt, vt, *self._idx)
            self._prefill_valid = n_valid       # what end_step adds
            q_offset = start
        else:
            if s != 1:
                raise ValueError(f"a sep decode step is [1, 1], got "
                                 f"[{b}, {s}]")
            pos_tok = int(self.lens[slot])
            base = sep["base"]
            if self._idx is None:
                blk0 = base // self.page_size
                n_tp = -(-(pos_tok + 1 - base) // self.page_size)
                # a power-of-two window keeps the shapes few
                npp = 1 << max(n_tp - 1, 0).bit_length()
                tbl = self._tables[slot, blk0:blk0 + npp]
                tbl = np.pad(tbl, (0, npp - tbl.shape[0]))
                self._idx = tuple(torch.as_tensor(np.asarray(a, np.int64))
                                  .to(k.device) for a in (
                    [self._tables[slot, pos_tok // self.page_size]],
                    [pos_tok % self.page_size], tbl))
            page_ids, slot_ids, window = self._idx
            self._scatter(layer, k_pages, v_pages, kt, vt, page_ids,
                          slot_ids)
            blocks.append((k_pages[:, window].reshape(kv_heads, -1, d)[None],
                           v_pages[:, window].reshape(kv_heads, -1, d)[None],
                           base))
            q_offset = pos_tok
        (q,) = amp.amp_cast_inputs("sep_ring_attention", [q])
        out = blockwise_causal_attention(q.transpose(1, 2), q_offset, blocks)
        return out.transpose(1, 2)

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
        return paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                               tables, ctx, k_scales=ks,
                               v_scales=vs)[:, None]

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
        out = ragged_paged_attention(q[0].contiguous(), k_pages, v_pages,
                                     tables, *desc,
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
        dev = next(iter(self.parameters())).device
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
