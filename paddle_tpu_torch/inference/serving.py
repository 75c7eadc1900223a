"""Serving engines (port of ``paddle_tpu/inference/serving.py``).

* :class:`ServingEngine`, the static window batcher: requests of one
  shape that arrive within ``batch_window_s`` run as one batch through
  ``model.generate`` over a paged KV cache.
* :class:`ContinuousServingEngine`, continuous batching over a
  :class:`~paddle_tpu_torch.models.generation.SlotPagedKVCache`, greedy
  or sampled per request row (seeded draws depend on the request's seed,
  the row and the token's index alone), with chunked prefill and a
  prefix cache. By default each tick packs up
  to ``token_budget`` tokens into ONE flat batch: every live decode
  slot's single token, then as many prefill tokens as fit (per-span cap
  ``prefill_chunk_tokens``), padded to a power of two and run through one
  ragged forward. With ``enable_ragged=False`` it runs the legacy
  two-program scheduler instead: per tick one prefill chunk, padded to a
  power-of-two bucket, for the longest-waiting slot, then one
  fixed-shape ``[max_batch, 1]`` decode step for every decoding slot.
  Admission maps a request onto a free slot and matches its prompt
  against the prefix index; no model work happens there. With
  ``kv_dtype="int8"`` the KV pages are int8 with fp32 row scales, and
  with ``weight_dtype="int8"`` every ``nn.Linear`` of the model is
  quantised in place (``quantization.quantize_linears``): together the
  fully-int8 serving configuration. With ``spec_decode=True`` a drafter
  (``inference/speculative.py``) proposes tokens that each tick verifies
  as decode spans of ``1 + k`` tokens. The tick shapes form a bounded
  family (:meth:`ContinuousServingEngine.declared_token_buckets`,
  :meth:`~ContinuousServingEngine.declared_chunk_buckets` and the one
  decode step); on CUDA each ragged bucket and the decode step is a CUDA
  graph, captured at its first use (or by
  :meth:`~ContinuousServingEngine.warmup_programs`) and replayed after.
  ``host_pool_mb`` puts a host-RAM tier under the prefix index, and
  ``sep_prefill=True`` serves prompts larger than the page pool by
  striped long-context prefill over the ring schedule.

Both engines follow the AMP state (:func:`~paddle_tpu_torch.amp.auto_cast`)
current at each tick, as the reference's do: the state is one per
process, so a caller's ``with amp.auto_cast(level="O2",
dtype="bfloat16"):`` around its requests holds for the serve thread too,
and each tick program (and CUDA graph) belongs to one state.

Both engines run the model on a serve thread of their own, which enters
``torch.inference_mode()`` itself. ``abort()`` fails every queued and
in-flight request at the next tick boundary instead of draining them.

    engine = ContinuousServingEngine(model)           # model on "cuda"
    with engine:
        out = engine.generate(prompt_ids, max_new_tokens=64)   # blocks
"""
from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque

import numpy as np
import torch

from .. import amp
from .._device import resolve_device
from ..models.generation import (KV_DTYPES, HostKVPool, SlotPagedKVCache,
                                 StagedBuffer, _row_generator,
                                 _sample_logits)
from ..ops import _build
from ..quantization import quantize_linears
from .speculative import DEFAULT_SPEC_K, _pow2_bucket, make_drafter

#: default cap on one prefill span per tick
DEFAULT_PREFILL_CHUNK_TOKENS = 256

#: default per-tick token budget: every live decode slot contributes 1
#: token, prefill spans fill the rest
DEFAULT_SERVING_TOKEN_BUDGET = 256

#: default stripe of the long-context (sep) prefill: every chunk of a long
#: prompt pads to this many tokens, one chunk shape
DEFAULT_SEP_STRIPE_TOKENS = 512


def _chunk_bucket(n_valid, cap):
    """Pad a prefill chunk to the next power-of-two bucket (min 8, capped
    at the chunk budget)."""
    b = 8
    while b < n_valid:
        b *= 2
    return min(b, max(int(cap), 1)) if n_valid <= cap else int(cap)


def _token_bucket(n, cap):
    """Pad a ragged tick's packed token batch to the next power of two
    (min 1, capped at the token budget)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(int(cap), 1)) if n <= cap else int(cap)


#: the options ContinuousServingEngine.generate takes besides the lengths
SAMPLING_OPTIONS = ("do_sample", "top_k", "top_p", "temperature", "seed",
                    "eos_token_id")

class _Control:
    """A function to run on the serve-loop thread at a tick boundary."""

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error = None

    def run(self, engine):
        try:
            self.result = self.fn(engine)
        except Exception as e:        # noqa: BLE001 — raised to the caller
            self.error = e
        finally:
            self.done.set()

    def fail(self, exc):
        if not self.done.is_set():
            self.error = exc
            self.done.set()


class _Request:
    def __init__(self, ids, max_new_tokens, **kwargs):
        self.ids = np.asarray(ids)
        if self.ids.ndim == 1:
            self.ids = self.ids[None]
        self.max_new_tokens = max_new_tokens
        self.kwargs = kwargs                 # generate() options
        self.eos_token_id = kwargs.get("eos_token_id")
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.cancelled = False         # client gave up (timeout)
        self._rows = []


class _Row:
    """One sequence of a request inside the scheduler; ``row_idx`` is its
    row within the request (seeded draws depend on it)."""

    def __init__(self, req, ids, row_idx=0):
        self.req = req
        self.row_idx = int(row_idx)
        self.prompt = np.asarray(ids)        # [s]
        self.generated: list = []
        self.done = False
        self.state = "queued"                # queued -> prefill -> decode
        self.sep = False                     # a long-context (sep) row


def _engine_device(model, device):
    """Resolve an engine's device (``None`` means ``"cuda"``) and check
    that the model's parameters live there."""
    dev = resolve_device(device)
    model_dev = next(iter(model.parameters())).device
    if model_dev.type != dev.type:
        raise ValueError(f"model on {model_dev}, engine on {dev}")
    return dev


def _as_ids(input_ids):
    ids = input_ids.cpu().numpy() if isinstance(input_ids, torch.Tensor) \
        else np.asarray(input_ids)
    return ids[None] if ids.ndim == 1 else ids


class _Engine:
    """What both engines share: a request queue drained by one serve
    thread that runs ``_serve()`` under ``torch.inference_mode()``, the
    lifecycle around it, and the blocking client side of ``generate``."""

    _STOP = object()

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread = None
        self._running = False
        self._aborted = False

    def _stop_error(self):
        """What a request the engine drops gets: aborted or stopped."""
        return RuntimeError("ServingEngine aborted" if self._aborted
                            else "engine stopped")

    # -- client API ----------------------------------------------------------
    def run_on_loop(self, fn, timeout=30.0):
        """Run ``fn(engine)`` on the serve-loop thread at the next tick
        boundary and return its result (raising its exception)."""
        if not self._running:
            raise RuntimeError("engine not started (call start())")
        ctl = _Control(fn)
        self._q.put(ctl)
        if not ctl.done.wait(timeout):
            raise TimeoutError("run_on_loop control not serviced")
        if ctl.error is not None:
            raise ctl.error
        return ctl.result

    def _submit(self, req, timeout):
        """Queue ``req`` and block until it is served, failed, or
        ``timeout`` seconds pass. Returns the result as a CPU tensor."""
        if not self._running:
            raise RuntimeError("engine not started (call start())")
        self._q.put(req)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not req.done.is_set():
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                # the scheduler drops the request at its next boundary
                req.cancelled = True
                raise TimeoutError("generate timed out")
            th = self._thread
            if not self._running and (th is None or not th.is_alive()):
                # raced with stop() and the worker that fails queued
                # requests is gone
                if not req.done.is_set():
                    req.error = self._stop_error()
                    req.done.set()
                break
            req.done.wait(0.5 if remaining is None else min(0.5, remaining))
        if req.error is not None:
            raise req.error
        return torch.as_tensor(req.result)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._running:
            return self
        # drop stale stop tokens from a previous stop()
        try:
            while True:
                item = self._q.get_nowait()
                if item is not self._STOP:
                    self._q.put(item)
                    break
        except queue.Empty:
            pass
        self._running = True
        self._aborted = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if not self._running and self._thread is None:
            return
        self._running = False
        self._q.put(self._STOP)
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def abort(self):
        """Hard stop (a replica's death): at the next tick boundary every
        queued and in-flight request fails with ``RuntimeError("ServingEngine
        aborted")``, its slots are freed, and the serve thread exits
        without draining. ``start()`` serves again."""
        self._aborted = True
        self.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _loop(self):
        try:
            # grad mode is per thread: the serve thread sets its own
            with torch.inference_mode():
                self._serve()
        finally:
            # fail requests stranded behind the stop token
            try:
                while True:
                    item = self._q.get_nowait()
                    if isinstance(item, _Request):
                        item.error = self._stop_error()
                        item.done.set()
                    elif isinstance(item, _Control):
                        item.fail(self._stop_error())
            except queue.Empty:
                pass


class ServingEngine(_Engine):
    """Thread-safe static window batcher around ``model.generate``.

    The serve thread takes one request, then collects requests of the
    same prompt length, ``max_new_tokens`` and options for up to
    ``batch_window_s`` seconds or until ``max_batch_size`` rows, and runs
    the group as one ``model.generate`` call, with a
    :class:`~paddle_tpu_torch.models.generation.PagedKVCache` of
    ``page_size`` pages unless ``use_paged_cache=False``. ``device=None``
    means ``"cuda"`` (raises where CUDA is absent); the model must live
    on that device.

        with ServingEngine(model) as engine:
            out = engine.generate(prompt_ids, max_new_tokens=64)
    """

    def __init__(self, model, max_batch_size=8, batch_window_s=0.005,
                 use_paged_cache=True, page_size=16, device=None):
        super().__init__()
        self.device = _engine_device(model, device)
        self.model = model
        self.max_batch = int(max_batch_size)
        self.window = float(batch_window_s)
        self.use_paged = bool(use_paged_cache)
        self.page_size = int(page_size)
        self.batches_run = 0

    def generate(self, input_ids, max_new_tokens=32, timeout=None,
                 **kwargs):
        """Decode ``input_ids`` (``[s]`` or ``[rows, s]``) with
        ``model.generate(**kwargs)`` inside a batch, and block until done.
        Returns an int64 CPU tensor ``[rows, s + generated]``. With
        ``eos_token_id`` the output is cut after the last row's first eos,
        so it does not depend on the lengths of its batch-mates."""
        if not self._running:
            raise RuntimeError("engine not started (call start())")
        return self._submit(_Request(_as_ids(input_ids), max_new_tokens,
                                     **kwargs), timeout)

    def _collect(self):
        """Block for one request, then take compatible ones within the
        window. Groups by (prompt length, max_new_tokens, options), so a
        batch is one shape."""
        first = self._q.get()
        while isinstance(first, _Control):
            first.run(self)
            first = self._q.get()
        if first is self._STOP:
            return None

        def key(r):
            return (r.ids.shape[1], r.max_new_tokens,
                    tuple(sorted(r.kwargs.items())))

        group = [first]
        deadline = time.monotonic() + self.window
        leftovers = []
        try:
            while sum(r.ids.shape[0] for r in group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if isinstance(nxt, _Control):
                    nxt.run(self)
                    continue
                if nxt is self._STOP:
                    self._q.put(self._STOP)      # re-post the stop token
                    break
                if key(nxt) == key(first) and (sum(
                        r.ids.shape[0] for r in group)
                        + nxt.ids.shape[0]) <= self.max_batch:
                    group.append(nxt)
                else:
                    leftovers.append(nxt)
        finally:
            for r in leftovers:                  # incompatible: next rounds
                self._q.put(r)
        return group

    def _serve(self):
        while self._running:
            group = self._collect()
            if group is None:
                break
            # a timed-out client already raised; no batch for it
            group = [r for r in group if not r.cancelled]
            if not group:
                continue
            try:
                batch = np.concatenate([r.ids for r in group], axis=0)
                kwargs = dict(group[0].kwargs)
                if self.use_paged:
                    kwargs.setdefault("use_paged_cache", True)
                    kwargs.setdefault("page_size", self.page_size)
                out = self.model.generate(
                    torch.as_tensor(batch, device=self.device),
                    max_new_tokens=group[0].max_new_tokens, **kwargs)
                if self._aborted:       # the batch is the tick: no delivery
                    raise self._stop_error()
                arr = out.cpu().numpy()
                self.batches_run += 1
                prompt_len = group[0].ids.shape[1]
                eos = kwargs.get("eos_token_id")
                row = 0
                for r in group:
                    n = r.ids.shape[0]
                    res = arr[row:row + n]
                    if eos is not None and arr.shape[1] > prompt_len:
                        # cut co-batch eos padding: past the request's own
                        # rows' first eos everything is eos
                        gen = res[:, prompt_len:]
                        hit = gen == eos
                        stop = int(np.max(np.where(
                            hit.any(axis=1), hit.argmax(axis=1) + 1,
                            gen.shape[1])))
                        res = res[:, :prompt_len + stop]
                    r.result = res
                    row += n
                    r.done.set()
            except Exception as e:      # noqa: BLE001 — fanned to callers
                for r in group:
                    r.error = e
                    r.done.set()


class _TickProgram:
    """One declared tick shape: the staged buffers its forward reads the
    token ids and positions from and, on a CUDA engine with graphs, the
    graph captured at its first use, its logits and the kernel launches
    it records (credited at each replay)."""

    def __init__(self, ids_shape, pos_shape, device):
        self.ids = StagedBuffer(ids_shape, torch.int64, device)
        self.pos = StagedBuffer(pos_shape, torch.int64, device)
        self.graph = None
        self.logits = None
        self.launches = None


class ContinuousServingEngine(_Engine):
    """Thread-safe continuous-batching ``generate`` front end with chunked
    prefill and a prefix cache, greedy or sampled per request row.

    ``device=None`` means ``"cuda"`` (raises where CUDA is absent); the
    model's parameters must live on that device. ``enable_ragged`` picks
    the ragged scheduler (default) or the legacy two-program one;
    ``ragged_impl`` picks the ragged attention grid, ``"qblock"`` or
    ``"token"``. ``kv_dtype`` (``None``, ``"auto"``, ``"native"`` or
    ``"int8"``) goes to the cache. ``weight_dtype="int8"`` quantises the
    model's ``nn.Linear`` layers in place (layers already quantised are
    skipped) and records their count in ``quantized_linears``; ``None``
    leaves the weights as they are. Unlike the reference, no environment
    variable sets either.

    Every ragged tick pads to one of :meth:`declared_token_buckets` and
    every legacy decode step is ``[max_batch, 1]``: each such shape reads
    its inputs from fixed buffers, so on CUDA it is one CUDA graph
    (``cuda_graphs=True``, the default), captured at its first use (that
    tick runs eagerly on the capture stream first) or ahead of traffic by
    :meth:`warmup_programs`, and replayed after; all of an engine's graphs
    share one memory pool. The launches a graph recorded are credited to
    the kernel wrappers' counters at each replay. A capture or replay that
    fails raises to the requests in flight; nothing falls back to eager.
    ``cuda_graphs=False`` runs the same ticks eagerly (the CPU always
    does). Legacy prefill chunks stay eager.

    ``spec_decode=True`` turns on speculative decoding (the ragged
    scheduler only): each tick a drafter proposes up to ``spec_k``
    (``None``: ``DEFAULT_SPEC_K``) tokens for every decode slot from the
    budget left over, the tick's forward verifies them as one span of
    ``1 + k`` tokens, and the longest prefix that matches the target's own
    tokens is kept with the token after it; the rest rolls back out of
    the cache (``SlotPagedKVCache.rollback``). ``drafter`` is any object
    with ``propose(history, k)``; without one, ``draft_model`` gives a
    :class:`~paddle_tpu_torch.inference.speculative.DraftModelDrafter`,
    else the n-gram drafter. ``draft_batch`` drafts for every slot with
    one padded forward a draft step. Greedy streams are spec off's, and a
    seeded row draws each token from the generator of its final index.
    Verify ticks pad to the same token buckets, so they replay the same
    graphs; draft forwards run eagerly.

    ``host_pool_mb`` (0: off) gives the caches a host tier
    (:class:`~paddle_tpu_torch.models.generation.HostKVPool`) of that
    many MiB: prefix pages the device LRU evicts are demoted there and
    promoted back, bit for bit, when an admission needs them, on either
    scheduler. The engine owns the pool, so a cache rebuilt after an
    error keeps the tier.

    ``sep_prefill=True`` (the ragged scheduler, native KV pages) serves
    prompts of ``sep_threshold_tokens`` or more (0: half the page pool,
    at least a stripe) by striped long-context prefill: chunks of
    ``sep_stripe_tokens`` (``DEFAULT_SEP_STRIPE_TOKENS``) whose K/V
    become stripes outside the page pool, attended with the ring
    schedule over B1, so a prompt larger than the pool serves; only its
    decode tail takes pages. Sep rows run one chunk or one decode token a
    tick, eagerly and outside the ragged pack, and are never drafted.
    ``sep_requests`` counts them; ``host_demotions``,
    ``host_promotions``, ``host_promote_rejects``, ``sep_stripes_stored``,
    ``sep_chunks`` and ``sep_decode_steps`` read the live cache's
    counters."""

    def __init__(self, model, max_batch_size=8, page_size=16, max_len=2048,
                 pad_token_id=0, prefill_chunk_tokens=None,
                 enable_prefix_cache=True, num_pages=None,
                 token_budget=None, enable_ragged=True,
                 ragged_impl="qblock", kv_dtype=None, weight_dtype=None,
                 cuda_graphs=True, device=None, spec_decode=False,
                 spec_k=None, drafter=None, draft_model=None,
                 draft_batch=True, host_pool_mb=0, sep_prefill=False,
                 sep_stripe_tokens=None, sep_threshold_tokens=0):
        super().__init__()
        self.device = _engine_device(model, device)
        self.model = model
        self.weight_dtype = (str(weight_dtype).lower()
                             if weight_dtype is not None else None)
        if self.weight_dtype not in (None, "int8"):
            raise ValueError(f"unsupported weight_dtype {weight_dtype!r} "
                             f"(expected None or 'int8')")
        self.quantized_linears = (quantize_linears(model)
                                  if self.weight_dtype == "int8" else 0)
        if kv_dtype is not None and str(kv_dtype).lower() not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        self.kv_dtype = kv_dtype
        self.max_batch = int(max_batch_size)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pad_token_id = int(pad_token_id)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = DEFAULT_PREFILL_CHUNK_TOKENS
        self.chunk_tokens = max(int(prefill_chunk_tokens), 1)
        if token_budget is None:
            token_budget = DEFAULT_SERVING_TOKEN_BUDGET
        # every live decode slot is entitled to its token per tick, so
        # the budget never starves decode
        self.token_budget = max(int(token_budget), self.max_batch, 1)
        self.num_pages = num_pages
        self.enable_ragged = bool(enable_ragged)
        self.ragged_impl = ragged_impl
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        # speculative decoding: a drafter proposes up to spec_k tokens a
        # decode slot a tick, the ragged forward verifies them as one span
        # of 1 + k tokens, and the longest matching prefix is kept
        self.enable_spec = bool(spec_decode)
        self.spec_k = max(int(DEFAULT_SPEC_K if spec_k is None else spec_k),
                          1)
        if self.enable_spec and not self.enable_ragged:
            raise ValueError("speculative decoding needs the ragged "
                             "scheduler (enable_ragged=True): a verify span "
                             "is a ragged span of 1 + k tokens")
        self._drafter = None
        if self.enable_spec:
            self._drafter = (drafter if drafter is not None
                             else make_drafter(draft_model=draft_model))
        # one padded draft forward a draft step for every decode slot
        # (the drafter's propose_batch), instead of one per slot
        self.draft_batch = bool(draft_batch)
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rounds = 0           # verify spans with >= 1 draft
        self.spec_draft_forwards = 0   # draft-model forwards
        self.spec_draft_ticks = 0      # ticks that ran the drafter
        # the host tier: one pool, owned by the engine, under every cache
        # it builds (a rebuilt cache keeps the warm tier); 0 MB is off
        self.host_pool_mb = float(host_pool_mb)
        if self.host_pool_mb < 0:
            raise ValueError(f"host_pool_mb must be >= 0, got "
                             f"{self.host_pool_mb}")
        self._host_pool = HostKVPool(self.host_pool_mb)
        # long-context prefill: prompts at or past the threshold are
        # chunked into stripes attended by the ring schedule, so the page
        # pool holds only their decode tail
        self.sep_prefill_enabled = bool(sep_prefill)
        self.sep_stripe = int(DEFAULT_SEP_STRIPE_TOKENS
                              if sep_stripe_tokens is None
                              else sep_stripe_tokens)
        self.sep_threshold = int(sep_threshold_tokens)
        self.sep_requests = 0
        if self.sep_prefill_enabled:
            if not self.enable_ragged:
                raise ValueError("sep prefill needs the ragged scheduler "
                                 "(enable_ragged=True)")
            if self.sep_stripe <= 0 or self.sep_stripe % self.page_size:
                raise ValueError(
                    f"sep_stripe_tokens {self.sep_stripe} must be a "
                    f"positive multiple of page_size {self.page_size}")
            if str(kv_dtype).lower() == "int8":
                raise ValueError("sep prefill requires native KV pages "
                                 "(kv_dtype='int8' is unsupported)")
        self._cache = None
        self._adopt = None             # a warmed cache the next serve takes
        # (tick shape, amp.state_key()) -> _TickProgram
        self._programs = {}
        self._graph_pool = None
        self._capture_stream = None
        self.ragged_steps = 0          # ragged packed forwards run
        self.prefills = 0              # rows admitted
        self.prefill_chunks = 0        # prefill spans / legacy chunks run
        self.prefill_chunk_buckets = Counter()   # legacy: padded size -> n
        self.decode_steps = 0          # ticks or steps with decode rows
        self.cancelled_rows = 0
        self.ragged_prefill_tokens = 0
        self.ragged_decode_tokens = 0
        # padded counts every token position a forward processed, useful
        # only the real ones
        self.padded_tokens_total = 0
        self.useful_tokens_total = 0
        self.ragged_buckets_used: set = set()
        self.graph_captures = 0
        self.graph_replays = 0
        # ("chunk", slot, n_valid, done) and ("decode", n_active), in order
        self.events: deque = deque(maxlen=4096)

    @property
    def prefix_hits(self):
        """Prompt blocks served from the prefix index by the live cache."""
        return 0 if self._cache is None else self._cache.prefix_hits

    def _cache_count(name):
        return property(lambda self: 0 if self._cache is None
                        else getattr(self._cache, name),
                        doc=f"The live cache's ``{name}``.")

    host_demotions = _cache_count("host_demotions")
    host_promotions = _cache_count("host_promotions")
    host_promote_rejects = _cache_count("host_promote_rejects")
    sep_stripes_stored = _cache_count("sep_stripes_stored")
    sep_chunks = _cache_count("sep_chunks")
    sep_decode_steps = _cache_count("sep_decode_steps")
    del _cache_count

    def generate(self, input_ids, max_new_tokens=32, max_length=None,
                 timeout=None, **kwargs):
        """Decode ``input_ids`` (``[s]`` or ``[rows, s]``, array or tensor)
        and block until done. Returns an int64 CPU tensor ``[rows, s +
        generated]``; rows that stop early at ``eos_token_id`` are padded
        with it. ``max_length`` overrides ``max_new_tokens`` as the total
        length; a zero budget returns the prompt unchanged. Options:
        ``do_sample`` (greedy without it), ``top_k``, ``top_p``,
        ``temperature``, ``seed`` (token ``i`` of row ``r`` draws from a
        generator of ``(seed, r, i)`` alone; without a seed, from the
        global generator) and ``eos_token_id``; any other raises
        ``TypeError``."""
        unknown = sorted(set(kwargs) - set(SAMPLING_OPTIONS))
        if unknown:
            raise TypeError(f"generate() got unexpected options {unknown}; "
                            f"it takes {SAMPLING_OPTIONS}")
        ids = _as_ids(input_ids)
        if max_length is not None:           # GenerationMixin's contract
            max_new_tokens = max(int(max_length) - ids.shape[1], 0)
        if max_new_tokens <= 0:
            return torch.as_tensor(ids)
        if ids.shape[1] + max_new_tokens > self.max_len:
            # fail THIS request up front: overflowing after admission
            # would fail every co-scheduled request with it
            raise ValueError(
                f"request needs {ids.shape[1]} + {max_new_tokens} tokens "
                f"> engine max_len {self.max_len}")
        return self._submit(_Request(ids, max_new_tokens, **kwargs), timeout)

    # -- the bounded program family -----------------------------------------
    def declared_token_buckets(self):
        """Every width a ragged tick pads to (:func:`_token_bucket`): the
        powers of two below ``token_budget``, and the budget."""
        out, b = set(), 1
        while b < self.token_budget:
            out.add(b)
            b *= 2
        out.add(self.token_budget)
        return out

    def declared_chunk_buckets(self):
        """Every width a legacy prefill chunk pads to
        (:func:`_chunk_bucket`): the powers of two from 8 below
        ``prefill_chunk_tokens``, and that cap."""
        out, b = set(), 8
        while b < self.chunk_tokens:
            out.add(b)
            b *= 2
        out.add(self.chunk_tokens)
        return out

    def declared_draft_buckets(self):
        """Every ``(rows, width)`` a batched draft forward pads to
        (:func:`~paddle_tpu_torch.inference.speculative._pow2_bucket`):
        ``(rows_buckets, width_buckets)``, rows up to the slot count's
        bucket, widths up to the drafter's window; None when batched
        drafting is off or the drafter has no batch path."""
        if not (self.enable_spec and self.draft_batch
                and hasattr(self._drafter, "propose_batch")):
            return None
        rows, b = set(), 1
        while b < _pow2_bucket(self.max_batch):
            rows.add(b)
            b *= 2
        rows.add(_pow2_bucket(self.max_batch))
        window = int(getattr(self._drafter, "window", 64))
        widths, b = set(), 1
        while b < window:
            widths.add(b)
            b *= 2
        widths.add(window)
        return rows, widths

    def warmup_programs(self, families=None):
        """Run every declared tick shape once before traffic, so that no
        request pays a first use: ``"serving.ragged"`` (each token
        bucket), or with ``enable_ragged=False`` ``"serving.prefill_chunk"``
        (each chunk bucket) and ``"serving.decode"``; with batched drafting
        ``"spec.draft_batch"`` (each of :meth:`declared_draft_buckets`, one
        draft forward of padding, uncounted); with ``sep_prefill``
        ``"serving.sep_prefill"`` and ``"serving.sep_decode"`` (one
        span of every stripe count and a decode step, on a scratch cache);
        with the host tier ``"kv.host_promote"`` (a demotion and a
        promotion on a scratch cache and pool). The ragged buckets
        and the decode step run as ticks of padding alone on the engine's
        own cache (writing only its scratch page), so on CUDA their graphs
        are captured here for the live cache; the chunks run on a
        one-slot scratch cache. Call it before :meth:`start` (the next
        serve adopts the warmed cache) or through :meth:`run_on_loop`,
        under the AMP state the ticks will run in: the programs warmed
        are that state's.
        Leaves the cache as it found it. Returns ``{family: seconds}``."""
        names = None if families is None else set(families)

        def want(name):
            return names is None or name in names

        if self._running:
            cache = self._cache
        else:
            cache = self._adopt = self._adopt or self._new_cache()
        out = {}
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                if self.enable_ragged and want("serving.ragged"):
                    t0 = time.perf_counter()
                    for b in sorted(self.declared_token_buckets()):
                        cache.begin_ragged([], num_tokens=b)
                        self._forward(("ragged", b),
                                      np.full((1, b), self.pad_token_id),
                                      np.zeros(b), cache)
                        cache.end_step()
                    self._sync()
                    out["serving.ragged"] = time.perf_counter() - t0
                if not self.enable_ragged and want("serving.prefill_chunk"):
                    t0 = time.perf_counter()
                    scratch = SlotPagedKVCache(
                        1, page_size=self.page_size, max_len=self.max_len,
                        num_pages=cache.pages_per_seq + 1,
                        enable_prefix_cache=False, kv_dtype=self.kv_dtype,
                        device=self.device)
                    for b in sorted(self.declared_chunk_buckets()):
                        scratch.assign(0, np.zeros(1, np.int64))
                        scratch.begin_prefill(0, 1)
                        self.model.forward(
                            np.full((1, b), self.pad_token_id),
                            cache=scratch, position_ids=np.zeros(b))
                        scratch.free(0)
                    self._sync()
                    out["serving.prefill_chunk"] = time.perf_counter() - t0
                if not self.enable_ragged and want("serving.decode"):
                    t0 = time.perf_counter()
                    cache.begin_decode(np.zeros(self.max_batch, bool))
                    self._forward(("decode",),
                                  np.full((self.max_batch, 1),
                                          self.pad_token_id),
                                  cache.lens[:, None], cache)
                    cache.end_step()
                    self._sync()
                    out["serving.decode"] = time.perf_counter() - t0
                draft = self.declared_draft_buckets()
                if draft is not None and want("spec.draft_batch"):
                    t0 = time.perf_counter()
                    for r in sorted(draft[0]):
                        for w in sorted(draft[1]):
                            self._drafter.model.forward(
                                np.zeros((r, w), np.int64))
                    self._sync()
                    out["spec.draft_batch"] = time.perf_counter() - t0
                if self.sep_prefill_enabled and (
                        want("serving.sep_prefill")
                        or want("serving.sep_decode")):
                    out.update(self._warm_sep(want))
                if self._host_pool.enabled and want("kv.host_promote"):
                    out["kv.host_promote"] = self._warm_host_promote()
        finally:
            if was_training:
                self.model.train()
        return out

    def _warm_sep(self, want):
        """``warmup_programs``' sep families on a scratch cache: one long
        span chunk by chunk through every stripe count, then one decode
        step over the stripes and the tail."""
        out = {}
        t0 = time.perf_counter()
        cache = SlotPagedKVCache(
            self.max_batch, page_size=self.page_size, max_len=self.max_len,
            num_pages=self.num_pages, enable_prefix_cache=False,
            kv_dtype=self.kv_dtype, device=self.device,
            allow_page_overcommit=True)
        stripe = self.sep_stripe
        n = min(self.max_len - 2, (self.max_len // stripe) * stripe
                + max(stripe // 2, 1))
        cache.assign_sep(0, n, stripe)
        start = 0
        while start < n:
            nv = min(stripe, n - start)
            cache.begin_sep_prefill(0, nv)
            self.model.forward(
                np.full((1, stripe), self.pad_token_id), cache=cache,
                position_ids=np.minimum(np.arange(start, start + stripe),
                                        start + nv - 1))
            cache.end_step()
            start += nv
        self._sync()
        if want("serving.sep_prefill"):
            out["serving.sep_prefill"] = time.perf_counter() - t0
        if want("serving.sep_decode"):
            t0 = time.perf_counter()
            cache.begin_sep_decode(0)
            self.model.forward(np.full((1, 1), self.pad_token_id),
                               cache=cache,
                               position_ids=cache.lens[:1, None].copy())
            cache.end_step()
            self._sync()
            out["serving.sep_decode"] = time.perf_counter() - t0
        cache.free(0)
        return out

    def _warm_host_promote(self):
        """``warmup_programs``' ``"kv.host_promote"``: a demotion and a
        promotion on a scratch cache over a scratch pool (the engine's
        tier stays as it is)."""
        t0 = time.perf_counter()
        cache = SlotPagedKVCache(
            1, page_size=self.page_size, max_len=self.max_len,
            kv_dtype=self.kv_dtype, device=self.device,
            host_pool=HostKVPool(max(self.host_pool_mb, 64)))
        n = 2 * self.page_size
        prompt = np.zeros(n, np.int64)
        cache.assign(0, prompt)
        cache.begin_prefill(0, n)
        self.model.forward(prompt[None], cache=cache,
                           position_ids=np.arange(n))
        cache.end_step()
        cache.commit_prefix(0)
        cache.free(0)
        while cache._evict_lru():
            pass
        cache.assign(0, prompt)               # a host hit: promotion
        cache.free(0)
        self._sync()
        return time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, key, ids, pos, cache):
        """One forward of tick shape ``key`` (``("ragged", tokens)`` or
        ``("decode",)``) over the armed ``cache``: the ids and positions
        staged into the shape's buffers, then the eager forward, or on a
        CUDA engine with graphs its graph (captured at the shape's first
        use). A program belongs to the shape and to the AMP state of the
        tick (:func:`amp.state_key`, read now, as the reference's ops read
        it at every call): a tick under another state has its own buffers
        and graph and never replays one captured under another. Returns
        the logits."""
        prog_key = (key, amp.state_key())
        prog = self._programs.get(prog_key)
        if prog is None:
            prog = self._programs[prog_key] = _TickProgram(
                ids.shape, ids.shape if key[0] == "decode" else (ids.shape[1],),
                self.device)
        prog.ids.fill(ids)
        prog.pos.fill(pos)
        if not self.cuda_graphs:
            return self.model.forward(prog.ids.dev, cache=cache,
                                      position_ids=prog.pos.dev)
        if prog.graph is None:
            return self._capture(prog, cache)
        prog.graph.replay()
        prog.launches.credit()
        self.graph_replays += 1
        return prog.logits

    def _capture(self, prog, cache):
        """Run the armed tick eagerly on the capture stream (which also
        makes its lazy state: cuBLAS handles, kernel libraries, the KV
        pools), then capture the same forward into ``prog``'s graph. The
        launches made while capturing run at the replays, not now: they go
        to the graph's launch record, credited at each replay. Returns the
        eager tick's logits."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            logits = self.model.forward(prog.ids.dev, cache=cache,
                                        position_ids=prog.pos.dev)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        if not cache._pools:
            raise RuntimeError("no KV pools to capture a tick over")
        graph = torch.cuda.CUDAGraph()
        with _build.record_launches() as launches, \
                torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                                 capture_error_mode="thread_local"):
            out = self.model.forward(prog.ids.dev, cache=cache,
                                     position_ids=prog.pos.dev)
        prog.graph, prog.logits, prog.launches = graph, out, launches
        self.graph_captures += 1
        return logits

    # -- scheduler ----------------------------------------------------------
    def _new_cache(self):
        """A new cache; the graphs captured over the last one's pools and
        buffers are dropped, and the next ticks capture again."""
        cache = SlotPagedKVCache(self.max_batch, page_size=self.page_size,
                                 max_len=self.max_len,
                                 num_pages=self.num_pages,
                                 enable_prefix_cache=self.enable_prefix_cache,
                                 ragged_impl=self.ragged_impl,
                                 kv_dtype=self.kv_dtype, device=self.device,
                                 host_pool=self._host_pool,
                                 allow_page_overcommit=(
                                     self.sep_prefill_enabled))
        self._programs = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.cuda_graphs else None)
        self._cache = cache           # test and smoke-run introspection
        return cache

    def _sep_engaged(self, cache, prompt_tokens):
        """Whether a prompt takes the long-context path: at or past
        ``sep_threshold_tokens``, or, with the default 0, past half the
        page pool (and never shorter than a stripe)."""
        if not self.sep_prefill_enabled:
            return False
        thr = self.sep_threshold
        if thr <= 0:
            cap = (cache.num_pages - 1) * self.page_size
            thr = max(cap // 2, self.sep_stripe)
        return int(prompt_tokens) >= thr

    def _admit(self, cache, free, active, pending, prefill_q, sep_q=None):
        """Map waiting rows onto free slots and match their prompts
        against the prefix index (promoting blocks the host tier holds),
        or arm a long prompt's slot for striped prefill (``sep_q``, the
        ragged scheduler's). No model work happens here."""
        while free and pending:
            row = pending.popleft()
            if row.req.cancelled:
                row.done = True
                self.cancelled_rows += 1
                continue
            if row.prompt.shape[0] < 1:
                raise ValueError("cannot serve an empty prompt")
            slot = free.popleft()
            if sep_q is not None and self._sep_engaged(
                    cache, row.prompt.shape[0]):
                cache.assign_sep(slot, row.prompt.shape[0], self.sep_stripe)
                row.sep = True
                row.state = "prefill"
                active[slot] = row
                sep_q.append(slot)
                self.prefills += 1
                self.sep_requests += 1
                continue
            cache.assign(slot, row.prompt)
            row.state = "prefill"
            active[slot] = row
            prefill_q.append(slot)
            self.prefills += 1

    def _token(self, row, logits, idx, greedy=None, offset=0):
        """Row ``row``'s token from ``logits[idx]``: the argmax (read from
        ``greedy``, the tick's argmax on the host, when given) unless the
        request samples; then one draw through ``_sample_logits`` from the
        row's generator of (seed, row, token index), or the global one
        without a seed. ``offset`` is the token's place past the row's
        generated ones (a verify span's positions), so a seeded draw
        depends on the token's final index alone."""
        kw = row.req.kwargs
        if not kw.get("do_sample", False):
            return int(greedy[idx] if greedy is not None
                       else logits[idx].float().argmax())
        seed = kw.get("seed")
        gen = (None if seed is None else
               _row_generator(seed, row.row_idx,
                              len(row.generated) + offset, logits.device))
        return int(_sample_logits(
            logits[idx:idx + 1].float(), True, kw.get("top_k", 0),
            kw.get("top_p", 1.0), kw.get("temperature", 1.0), gen)[0])

    def _push_token(self, cache, free, active, slot, token):
        row = active[slot]
        row.generated.append(token)
        eos = row.req.eos_token_id
        if (eos is not None and token == eos) or \
                len(row.generated) >= row.req.max_new_tokens:
            row.done = True
            active[slot] = None
            cache.free(slot)
            free.append(slot)
            self._maybe_finish(row.req)

    def _maybe_finish(self, req):
        rows = req._rows
        if not all(r.done for r in rows):
            return
        if req.cancelled:              # the caller already raised
            req.done.set()
            return
        eos = req.eos_token_id
        pad = self.pad_token_id if eos is None else eos
        width = req.ids.shape[1] + max(len(r.generated) for r in rows)
        out = np.full((len(rows), width), pad, np.int64)
        for i, r in enumerate(rows):
            seq = np.concatenate([r.prompt, np.asarray(r.generated,
                                                       np.int64)])
            out[i, :seq.shape[0]] = seq
        req.result = out
        req.done.set()

    def _serve(self):
        was_training = self.model.training
        self.model.eval()
        try:
            cache, self._adopt = self._adopt or self._new_cache(), None
            tick = self._tick if self.enable_ragged else self._legacy_tick
            free: deque = deque(range(self.max_batch))
            active: list = [None] * self.max_batch
            pending: deque = deque()
            prefill_q: deque = deque()    # slots mid-prefill, FIFO
            sep_q: deque = deque()        # slots mid long-context prefill

            def enqueue(item):
                """False = stop token; otherwise split into rows."""
                if item is self._STOP:
                    return False
                if isinstance(item, _Control):
                    item.run(self)       # tick boundary: scheduler-safe
                    return True
                item._rows = [_Row(item, row, i)
                              for i, row in enumerate(item.ids)]
                pending.extend(item._rows)
                return True

            def drop_slot(i):
                active[i] = None
                cache.free(i)
                if i in prefill_q:
                    prefill_q.remove(i)
                if i in sep_q:
                    sep_q.remove(i)
                free.append(i)

            while True:
                if self._aborted:
                    # no drain: every queued and in-flight request fails
                    # now, and the slots it held are freed
                    err = self._stop_error()
                    for row in list(pending) + [r for r in active
                                                if r is not None]:
                        row.req.error = err
                        row.req.done.set()
                    pending.clear()
                    for i, r in enumerate(active):
                        if r is not None:
                            drop_slot(i)
                    break
                draining = not self._running
                if draining and all(r is None for r in active):
                    break
                # block only when idle; otherwise drain without waiting
                if not draining and not pending and \
                        all(r is None for r in active):
                    if not enqueue(self._q.get()):
                        self._running = False
                        continue     # drain in-flight rows before exit
                if not draining:
                    try:
                        while True:
                            if not enqueue(self._q.get_nowait()):
                                self._running = False
                                break
                    except queue.Empty:
                        pass
                if not self._running and pending:
                    # stop(): rows not admitted yet fail now, and so do
                    # their admitted sibling rows
                    dropped = {row.req for row in pending}
                    for row in pending:
                        row.req.error = self._stop_error()
                        row.req.done.set()
                    pending.clear()
                    for i, r in enumerate(active):
                        if r is not None and r.req in dropped:
                            drop_slot(i)
                # cancellation sweep: free what timed-out clients hold
                for i, r in enumerate(active):
                    if r is not None and r.req.cancelled:
                        r.done = True
                        self.cancelled_rows += 1
                        drop_slot(i)
                try:
                    if self._running:
                        self._admit(cache, free, active, pending, prefill_q,
                                    sep_q if self.enable_ragged else None)
                    tick(cache, free, active, prefill_q, sep_q)
                except Exception as e:      # noqa: BLE001 — fail in-flight
                    reqs = {r.req for r in pending}
                    reqs |= {r.req for r in active if r is not None}
                    for req in reqs:
                        req.error = e
                        req.done.set()
                    pending.clear()
                    prefill_q.clear()
                    sep_q.clear()
                    active = [None] * self.max_batch
                    free = deque(range(self.max_batch))
                    cache = self._new_cache()
        finally:
            if was_training:
                self.model.train()

    def _drafts(self, cache, active, decode_slots):
        """The drafter's proposals of this tick, ``{slot: tokens}``. Drafts
        ride on leftover budget alone: every decode slot keeps its one
        token, and no draft passes ``max_len`` or the row's remaining
        ``max_new_tokens``. Batched drafting asks every slot for the most
        any packing could grant it and trims each greedy proposal (prefix
        stable in k) to the room the packing below grants, so both paths
        propose the same tokens."""
        drafter = self._drafter
        if drafter is None or not decode_slots:
            return {}
        f0 = getattr(drafter, "forwards", None)

        def history(row):
            return np.concatenate([row.prompt, np.asarray(row.generated,
                                                          row.prompt.dtype)])

        def room(row, start, budget):
            return min(budget, self.spec_k, self.max_len - start - 1,
                       row.req.max_new_tokens - len(row.generated) - 1)

        batch = None
        if self.draft_batch and hasattr(drafter, "propose_batch"):
            caps = [max(0, room(active[i], int(cache.lens[i]),
                                self.token_budget - len(decode_slots)))
                    for i in decode_slots]
            batch = (drafter.propose_batch([history(active[i])
                                            for i in decode_slots], caps)
                     if max(caps) > 0 else [[] for _ in caps])
        drafts, off = {}, 0
        for di, i in enumerate(decode_slots):
            row = active[i]
            n = room(row, int(cache.lens[i]), self.token_budget - off - 1
                     - (len(decode_slots) - di - 1))
            if n <= 0:
                draft = []
            elif batch is not None:
                draft = batch[di][:n]
            else:
                draft = drafter.propose(history(row), n)[:n]
            if draft:
                drafts[i] = [int(t) for t in draft]
            off += 1 + len(draft)
        self.spec_draft_ticks += 1
        if f0 is not None:
            self.spec_draft_forwards += drafter.forwards - f0
        return drafts

    def _tick(self, cache, free, active, prefill_q, sep_q):
        """Pack and run one ragged tick: decode tokens first (each with
        the drafter's proposal behind it, a verify span, when speculative
        decoding is on), then as many prefill tokens as the budget
        admits. Sep rows stay out of the pack and out of drafting: their
        chunk and decode steps run first (:meth:`_sep_tick`)."""
        decode_slots = [i for i, r in enumerate(active)
                        if r is not None and r.state == "decode"
                        and not r.sep]
        drafts = self._drafts(cache, active, decode_slots)
        spans = []        # (slot, q_start, start, n, kind)
        off = 0
        for i in decode_slots:
            n = 1 + len(drafts.get(i, ()))
            spans.append((i, off, int(cache.lens[i]), n, "decode"))
            off += n
        remaining = self.token_budget - off
        for slot in list(prefill_q):
            if remaining <= 0:
                break
            row = active[slot]
            start = int(cache.lens[slot])
            n = min(self.chunk_tokens, row.prompt.shape[0] - start,
                    remaining)
            if n <= 0:
                break
            spans.append((slot, off, start, n, "prefill"))
            off += n
            remaining -= n
        self._sep_tick(cache, free, active, sep_q)
        if not spans:
            return
        total = off
        padded = _token_bucket(total, self.token_budget)
        flat = np.full(padded, self.pad_token_id, np.int64)
        pos = np.zeros(padded, np.int64)
        for slot, qs, start, n, kind in spans:
            row = active[slot]
            if kind == "decode":
                flat[qs] = (row.generated[-1] if row.generated
                            else row.prompt[-1])
                flat[qs + 1:qs + n] = drafts.get(slot, ())
            else:
                flat[qs:qs + n] = row.prompt[start:start + n]
            pos[qs:qs + n] = np.arange(start, start + n)
        cache.begin_ragged([(slot, qs, n) for slot, qs, _, n, _ in spans],
                           num_tokens=padded)
        lg = self._forward(("ragged", padded), flat[None], pos, cache)[0]
        cache.end_step()
        greedy = lg.float().argmax(-1).cpu().numpy()
        self.ragged_steps += 1
        self.ragged_buckets_used.add(padded)
        self.padded_tokens_total += padded
        self.useful_tokens_total += total
        n_decode = sum(n for _, _, _, n, kind in spans if kind == "decode")
        self.ragged_decode_tokens += n_decode
        self.ragged_prefill_tokens += total - n_decode

        # prefill spans: register finished prompts, hand them to decode
        for slot, qs, start, n, kind in spans:
            if kind != "prefill":
                continue
            row = active[slot]
            self.prefill_chunks += 1
            done = start + n >= row.prompt.shape[0]
            self.events.append(("chunk", slot, n, done))
            if not done:
                continue
            prefill_q.remove(slot)
            cache.commit_prefix(slot)
            row.state = "decode"
            self._push_token(cache, free, active, slot,
                             self._token(row, lg, qs + n - 1, greedy))
        if not decode_slots:
            return
        self.decode_steps += 1
        self.events.append(("decode", len(decode_slots)))
        # decode spans: the target's token at span offset j stands only if
        # every draft before it matched, so the longest matching prefix and
        # the token after it are emitted, and the rejected drafts' K/V
        # leave the context
        for slot, qs, start, n, kind in spans:
            if kind != "decode":
                continue
            row = active[slot]
            if row is None or row.done:
                continue
            draft = drafts.get(slot, ())
            kd = len(draft)
            targets = [self._token(row, lg, qs + j, greedy, offset=j)
                       for j in range(kd + 1)]
            m = 0
            while m < kd and draft[m] == targets[m]:
                m += 1
            if kd:
                self.spec_rounds += 1
                self.spec_drafted_tokens += kd
                self.spec_accepted_tokens += m
                if kd > m:
                    cache.rollback(slot, kd - m)
            for t in targets[:m + 1]:
                self._push_token(cache, free, active, slot, t)
                if active[slot] is None:
                    break

    # -- long-context (sep) rows ---------------------------------------------
    def _sep_tick(self, cache, free, active, sep_q):
        """One sep step a tick: a stripe chunk of the longest-waiting sep
        slot, then one decode token for every sep row already decoding.
        Their forwards are stripe- or tail-shaped and never join the
        ragged pack, so interleaving them at tick granularity keeps the
        paged traffic flowing beside a long prefill."""
        if sep_q:
            slot = sep_q[0]
            if self._sep_prefill_chunk(cache, free, active, slot):
                sep_q.popleft()
        for i, r in enumerate(active):
            if r is not None and r.sep and r.state == "decode":
                self._sep_decode_step(cache, free, active, i)

    def _sep_prefill_chunk(self, cache, free, active, slot):
        """One stripe-sized chunk of a sep slot, padded with
        ``pad_token_id`` (pad positions repeat the last real one); on the
        prompt's last chunk the row gets its first token and turns to sep
        decode. Returns True once the prompt is consumed."""
        row = active[slot]
        stripe = self.sep_stripe
        start = int(cache.lens[slot])
        n_valid = min(stripe, row.prompt.shape[0] - start)
        chunk = np.full(stripe, self.pad_token_id, np.int64)
        chunk[:n_valid] = row.prompt[start:start + n_valid]
        pos = np.minimum(np.arange(start, start + stripe),
                         start + n_valid - 1)
        cache.begin_sep_prefill(slot, n_valid)
        logits = self.model.forward(chunk[None], cache=cache,
                                    position_ids=pos)[0]
        cache.end_step()
        self.prefill_chunks += 1
        self.padded_tokens_total += stripe
        self.useful_tokens_total += n_valid
        done = start + n_valid >= row.prompt.shape[0]
        self.events.append(("sep_chunk", slot, n_valid, done))
        if not done:
            return False
        row.state = "decode"
        self._push_token(cache, free, active, slot,
                         self._token(row, logits, n_valid - 1))
        return True

    def _sep_decode_step(self, cache, free, active, slot):
        """One decode token of a sep row: every stripe and the tail window
        merged by the ring schedule."""
        row = active[slot]
        cur = np.asarray([[row.generated[-1] if row.generated
                           else row.prompt[-1]]], np.int64)
        pos = np.asarray([[int(cache.lens[slot])]], np.int64)
        cache.begin_sep_decode(slot)
        logits = self.model.forward(cur, cache=cache, position_ids=pos)[0]
        cache.end_step()
        self.decode_steps += 1
        self._push_token(cache, free, active, slot,
                         self._token(row, logits, 0))

    # -- legacy two-program scheduler ---------------------------------------
    def _legacy_tick(self, cache, free, active, prefill_q, sep_q=None):
        """One prefill chunk for the longest-waiting mid-prefill slot,
        then one fixed-shape decode step for every decoding slot."""
        if prefill_q:
            self._prefill_chunk(cache, free, active, prefill_q)
        mask = np.asarray([r is not None and r.state == "decode"
                           for r in active])
        n_active = int(mask.sum())
        if not n_active:
            return
        cache.begin_decode(mask)
        cur = np.full((self.max_batch, 1), self.pad_token_id, np.int64)
        for i, r in enumerate(active):
            if mask[i]:
                cur[i, 0] = r.generated[-1] if r.generated else r.prompt[-1]
        lg = self._forward(("decode",), cur, cache.lens[:, None],
                           cache)[:, -1]
        cache.end_step()
        greedy = lg.float().argmax(-1).cpu().numpy()
        self.decode_steps += 1
        # the fixed-shape step spends a token position on every slot
        self.padded_tokens_total += self.max_batch
        self.useful_tokens_total += n_active
        self.events.append(("decode", n_active))
        for i in np.nonzero(mask)[0]:
            self._push_token(cache, free, active, int(i),
                             self._token(active[i], lg, int(i), greedy))

    def _prefill_chunk(self, cache, free, active, prefill_q):
        """Run one bucket-padded prefill chunk for ``prefill_q[0]``. On the
        prompt's last chunk, register its full blocks in the prefix index
        and hand the row its first token."""
        slot = prefill_q[0]
        row = active[slot]
        start = int(cache.lens[slot])
        n_valid = min(self.chunk_tokens, row.prompt.shape[0] - start)
        padded = _chunk_bucket(n_valid, self.chunk_tokens)
        chunk = np.full(padded, self.pad_token_id, np.int64)
        chunk[:n_valid] = row.prompt[start:start + n_valid]
        # pad positions repeat the last real one: their output is
        # discarded, and they stay inside the rope table
        pos = np.minimum(np.arange(start, start + padded),
                         start + n_valid - 1)
        cache.begin_prefill(slot, n_valid)
        lg = self.model.forward(chunk[None], cache=cache,
                                position_ids=pos)[0]
        cache.end_step()
        self.prefill_chunks += 1
        self.prefill_chunk_buckets[padded] += 1
        self.padded_tokens_total += padded
        self.useful_tokens_total += n_valid
        done = start + n_valid >= row.prompt.shape[0]
        self.events.append(("chunk", slot, n_valid, done))
        if not done:
            return
        prefill_q.popleft()
        cache.commit_prefix(slot)
        row.state = "decode"
        self._push_token(cache, free, active, slot,
                         self._token(row, lg, n_valid - 1))
