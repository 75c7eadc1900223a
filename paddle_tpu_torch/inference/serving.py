"""Continuous-batching serving engine (port of the ragged scheduler of
``paddle_tpu/inference/serving.py``).

Each tick packs up to ``token_budget`` tokens into ONE flat batch: every
live decode slot's single token, then as many prefill tokens as fit
(per-span cap ``prefill_chunk_tokens``). The batch is padded to a power
of two, run through one ``model.forward`` over a
:class:`~paddle_tpu_torch.models.generation.SlotPagedKVCache` in ragged
mode, and the argmax of each span's last position is its next token.
Admission maps a request onto a free slot and matches its prompt
against the prefix index; no model work happens there.

    engine = ContinuousServingEngine(model)           # model on "cuda"
    with engine:
        out = engine.generate(prompt_ids, max_new_tokens=64)   # blocks
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..models.generation import SlotPagedKVCache

#: default cap on one prefill span per tick
DEFAULT_PREFILL_CHUNK_TOKENS = 256

#: default per-tick token budget: every live decode slot contributes 1
#: token, prefill spans fill the rest
DEFAULT_SERVING_TOKEN_BUDGET = 256


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
    def __init__(self, ids, max_new_tokens, eos_token_id=None):
        self.ids = np.asarray(ids)
        if self.ids.ndim == 1:
            self.ids = self.ids[None]
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.cancelled = False         # client gave up (timeout)
        self._rows = []


class _Row:
    """One sequence of a request inside the scheduler."""

    def __init__(self, req, ids):
        self.req = req
        self.prompt = np.asarray(ids)        # [s]
        self.generated: list = []
        self.done = False
        self.state = "queued"                # queued -> prefill -> decode


class ContinuousServingEngine:
    """Thread-safe continuous-batching ``generate`` front end with greedy
    decoding, chunked prefill and a prefix cache.

    ``device=None`` means ``"cuda"`` (raises where CUDA is absent); the
    model's parameters must live on that device. ``ragged_impl`` picks
    the attention grid, ``"qblock"`` or ``"token"``."""

    _STOP = object()

    def __init__(self, model, max_batch_size=8, page_size=16, max_len=2048,
                 pad_token_id=0, prefill_chunk_tokens=None,
                 enable_prefix_cache=True, num_pages=None,
                 token_budget=None, ragged_impl="qblock", device=None):
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type:
            raise ValueError(f"model on {model_dev}, engine on {self.device}")
        self.model = model
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
        self.ragged_impl = ragged_impl
        self._q: queue.Queue = queue.Queue()
        self._thread = None
        self._running = False
        self._cache = None
        self.ragged_steps = 0          # ragged packed forwards run
        # padded counts every token position a forward processed, useful
        # only the real ones
        self.padded_tokens_total = 0
        self.useful_tokens_total = 0

    @property
    def prefix_hits(self):
        """Prompt blocks served from the prefix index by the live cache."""
        return 0 if self._cache is None else self._cache.prefix_hits

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

    def generate(self, input_ids, max_new_tokens=32, timeout=None,
                 eos_token_id=None):
        """Greedy-decode ``input_ids`` (``[s]`` or ``[rows, s]``, array or
        tensor) and block until done. Returns an int64 CPU tensor
        ``[rows, s + generated]``; rows that stop early at
        ``eos_token_id`` are padded with it."""
        ids = input_ids.cpu().numpy() if isinstance(input_ids, torch.Tensor) \
            else np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        if max_new_tokens <= 0:
            return torch.as_tensor(ids)
        if ids.shape[1] + max_new_tokens > self.max_len:
            # fail THIS request up front: overflowing after admission
            # would fail every co-scheduled request with it
            raise ValueError(
                f"request needs {ids.shape[1]} + {max_new_tokens} tokens "
                f"> engine max_len {self.max_len}")
        if not self._running:
            raise RuntimeError("engine not started (call start())")
        req = _Request(ids, max_new_tokens, eos_token_id)
        self._q.put(req)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not req.done.is_set():
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                # the scheduler frees the request's slots at the next tick
                req.cancelled = True
                raise TimeoutError("generate timed out")
            th = self._thread
            if not self._running and (th is None or not th.is_alive()):
                # raced with stop() and the worker that fails queued
                # requests is gone
                if not req.done.is_set():
                    req.error = RuntimeError("engine stopped")
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

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _loop(self):
        try:
            # grad mode is per thread: the serve thread sets its own
            with torch.inference_mode():
                self._serve_ragged()
        finally:
            # fail requests stranded behind the stop token
            try:
                while True:
                    item = self._q.get_nowait()
                    if isinstance(item, _Request):
                        item.error = RuntimeError("engine stopped")
                        item.done.set()
                    elif isinstance(item, _Control):
                        item.fail(RuntimeError("engine stopped"))
            except queue.Empty:
                pass

    # -- scheduler ----------------------------------------------------------
    def _new_cache(self):
        cache = SlotPagedKVCache(self.max_batch, page_size=self.page_size,
                                 max_len=self.max_len,
                                 num_pages=self.num_pages,
                                 enable_prefix_cache=self.enable_prefix_cache,
                                 ragged_impl=self.ragged_impl)
        self._cache = cache           # test and smoke-run introspection
        return cache

    def _admit(self, cache, free, active, pending, prefill_q):
        """Map waiting rows onto free slots and match their prompts
        against the prefix index. No model work happens here."""
        while free and pending:
            row = pending.popleft()
            if row.req.cancelled:
                row.done = True
                continue
            if row.prompt.shape[0] < 1:
                raise ValueError("cannot serve an empty prompt")
            slot = free.popleft()
            cache.assign(slot, row.prompt)
            row.state = "prefill"
            active[slot] = row
            prefill_q.append(slot)

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

    def _serve_ragged(self):
        was_training = self.model.training
        self.model.eval()
        try:
            cache = self._new_cache()
            free: deque = deque(range(self.max_batch))
            active: list = [None] * self.max_batch
            pending: deque = deque()
            prefill_q: deque = deque()    # slots mid-prefill, FIFO

            def enqueue(item):
                """False = stop token; otherwise split into rows."""
                if item is self._STOP:
                    return False
                if isinstance(item, _Control):
                    item.run(self)       # tick boundary: scheduler-safe
                    return True
                item._rows = [_Row(item, row) for row in item.ids]
                pending.extend(item._rows)
                return True

            def drop_slot(i):
                active[i] = None
                cache.free(i)
                if i in prefill_q:
                    prefill_q.remove(i)
                free.append(i)

            while True:
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
                        row.req.error = RuntimeError("engine stopped")
                        row.req.done.set()
                    pending.clear()
                    for i, r in enumerate(active):
                        if r is not None and r.req in dropped:
                            drop_slot(i)
                # cancellation sweep: free what timed-out clients hold
                for i, r in enumerate(active):
                    if r is not None and r.req.cancelled:
                        r.done = True
                        drop_slot(i)
                try:
                    if self._running:
                        self._admit(cache, free, active, pending, prefill_q)
                    self._tick(cache, free, active, prefill_q)
                except Exception as e:      # noqa: BLE001 — fail in-flight
                    reqs = {r.req for r in pending}
                    reqs |= {r.req for r in active if r is not None}
                    for req in reqs:
                        req.error = e
                        req.done.set()
                    pending.clear()
                    prefill_q.clear()
                    active = [None] * self.max_batch
                    free = deque(range(self.max_batch))
                    cache = self._new_cache()
        finally:
            if was_training:
                self.model.train()

    def _tick(self, cache, free, active, prefill_q):
        """Pack and run one ragged tick: decode tokens first, then as many
        prefill tokens as the budget admits."""
        decode_slots = [i for i, r in enumerate(active)
                        if r is not None and r.state == "decode"]
        spans = []        # (slot, q_start, start, n, kind)
        off = 0
        for i in decode_slots:
            spans.append((i, off, int(cache.lens[i]), 1, "decode"))
            off += 1
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
            else:
                flat[qs:qs + n] = row.prompt[start:start + n]
            pos[qs:qs + n] = np.arange(start, start + n)
        cache.begin_ragged([(slot, qs, n) for slot, qs, _, n, _ in spans])
        logits = self.model.forward(flat[None], cache=cache,
                                    position_ids=pos)
        greedy = logits[0].float().argmax(-1).cpu().numpy()
        self.ragged_steps += 1
        self.padded_tokens_total += padded
        self.useful_tokens_total += total

        # prefill spans: register finished prompts, hand them to decode
        for slot, qs, start, n, kind in spans:
            if kind != "prefill":
                continue
            row = active[slot]
            if start + n < row.prompt.shape[0]:
                continue
            prefill_q.remove(slot)
            cache.commit_prefix(slot)
            row.state = "decode"
            self._push_token(cache, free, active, slot,
                             int(greedy[qs + n - 1]))
        for slot, qs, start, n, kind in spans:
            if kind != "decode":
                continue
            row = active[slot]
            if row is None or row.done:
                continue
            self._push_token(cache, free, active, slot, int(greedy[qs]))
