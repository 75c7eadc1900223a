"""The port's continuous-batching engine against the JAX engine on shared
weights: greedy token streams bit for bit, the same prefix-cache hits and
the same free pages after draining. Plus the page-cache bookkeeping and
scheduler helpers, operation by operation."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models import generation as jgen

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import generation as tgen
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(_no_reference_mesh):  # noqa: F811
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts():
    # the reference acceptance prompts (test_qblock_attention.py), then
    # two prompts sharing a 33-token prefix (two full 16-token blocks)
    rng = np.random.RandomState(1)
    base = [rng.randint(0, 128, (1, n)).astype(np.int64)
            for n in (23, 5, 37, 11)]
    prefix = rng.randint(0, 128, 33)
    shared = [np.concatenate([prefix, rng.randint(0, 128, n)])[None]
              .astype(np.int64) for n in (7, 4)]
    # the first sharer runs among the first four; the second waits for a
    # free slot, by which time the first has committed its prefix
    return [shared[0]] + base + [shared[1]]


def _drive_in_order(eng, prompts, new_tokens, **kw):
    """Submit every request while the serve loop is held at a tick
    boundary, one at a time, so both engines see the same arrival order
    and admit the same rows on the same tick. ``kw`` goes to every
    ``generate`` call."""
    results = [None] * len(prompts)
    entered, release = threading.Event(), threading.Event()

    def hold(_):
        entered.set()
        release.wait(60)

    with eng:
        holder = threading.Thread(target=lambda: eng.run_on_loop(hold, 60))
        holder.start()
        assert entered.wait(60)
        threads = []
        for i, p in enumerate(prompts):
            n = eng._q.qsize()
            t = threading.Thread(target=lambda i=i, p=p: results.__setitem__(
                i, np.asarray(eng.generate(p, max_new_tokens=new_tokens,
                                           timeout=300, **kw))))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 30
            while eng._q.qsize() == n and time.monotonic() < deadline:
                time.sleep(0.001)
        release.set()
        for t in threads + [holder]:
            t.join(300)
            assert not t.is_alive()
    return results


@pytest.fixture(scope="module")
def shared_models():
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2, max_position_embeddings=256))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2,
                                           max_position_embeddings=256),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


ENGINE_KW = dict(max_batch_size=4, max_len=64, token_budget=16,
                 prefill_chunk_tokens=16)


def test_engine_streams_bit_identical_to_jax(shared_models, monkeypatch):
    jm, tm = shared_models
    prompts = _prompts()
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    jeng = JaxEngine(jm, **ENGINE_KW)
    want = _drive_in_order(jeng, prompts, 5)
    teng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW)
    got = _drive_in_order(teng, prompts, 5)
    for w, g, p in zip(want, got, prompts):
        assert g.dtype == np.int64 and g.shape == (1, p.shape[1] + 5)
        np.testing.assert_array_equal(g, w)
    assert teng.ragged_steps == jeng.ragged_steps > 0
    assert teng.prefix_hits == jeng._cache.prefix_hits > 0
    assert teng._cache.free_page_count == jeng._cache.free_page_count
    assert (teng.padded_tokens_total, teng.useful_tokens_total) == (
        jeng.padded_tokens_total, jeng.useful_tokens_total)


def test_engine_token_grid_matches_qblock_grid(shared_models):
    """The per-token escape hatch serves the same greedy streams."""
    _, tm = shared_models
    prompts = _prompts()[:4]
    outs = []
    for impl in ("qblock", "token"):
        eng = pt.ContinuousServingEngine(tm, device="cpu", ragged_impl=impl,
                                         **ENGINE_KW)
        outs.append(_drive_in_order(eng, prompts, 4))
    for a, b, p in zip(*outs, prompts):
        assert a.shape == (1, p.shape[1] + 4)
        np.testing.assert_array_equal(a, b)


def test_engine_rejects_overlong_and_unstarted(shared_models):
    _, tm = shared_models
    eng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError):
        eng.generate(np.zeros(60, np.int64), max_new_tokens=5)
    with pytest.raises(RuntimeError):
        eng.generate(np.zeros(6, np.int64), max_new_tokens=5)


def test_bucket_helpers_match_jax():
    for cap in (1, 8, 16, 256):
        for n in range(1, 300):
            assert tserving._token_bucket(n, cap) == \
                jserving._token_bucket(n, cap)
            assert tserving._chunk_bucket(n, cap) == \
                jserving._chunk_bucket(n, cap)


def test_cache_bookkeeping_matches_jax():
    """The same admission / tick / commit / free sequence leaves both
    packages' caches with the same tables, refcounts, prefix index and
    free list, through prefix hits, copy-on-write and LRU eviction of a
    small pool. No model runs: pages are allocated at begin_ragged."""
    rng = np.random.RandomState(4)
    a = rng.randint(0, 100, 40)
    b = np.concatenate([a[:32], rng.randint(0, 100, 5)])
    c = rng.randint(0, 100, 28)
    caches = [jgen.SlotPagedKVCache(3, page_size=8, max_len=48,
                                    num_pages=10),
              tgen.SlotPagedKVCache(3, page_size=8, max_len=48,
                                    num_pages=10)]
    for cache in caches:
        assert cache.assign(0, a) == (0, 0, 5)
        cache.begin_ragged([(0, 0, 40)])
        cache.advance(40)
        cache.commit_prefix(0)
        assert cache.assign(1, b) == (32, 4, 0)       # prefix hit
        cache.begin_ragged([(0, 0, 1), (1, 1, 5)])
        cache.advance(6)
        cache.commit_prefix(1)
        cache.free(0)
        cache.assign(2, c)
        cache.begin_ragged([(1, 0, 1), (2, 1, 28)])   # evicts an LRU page
        cache.advance(29)
        cache.free(1)
        # a registered page written in place is copied first
        page = int(cache._tables[2, 1])
        cache._index[b"pin"] = page
        cache._page_digest[page] = b"pin"
        cache._ref[page] += 1
        cache.lens[2] = 11
        cache.begin_ragged([(2, 0, 1)])
    j, t = caches
    np.testing.assert_array_equal(t._tables, j._tables)
    np.testing.assert_array_equal(t._ref, j._ref)
    np.testing.assert_array_equal(t.lens, j.lens)
    assert list(t._index.items()) == list(j._index.items())
    assert list(t._free) == list(j._free)
    assert (t.prefix_hits, t.prefix_misses, t.cow_copies,
            t.prefix_evictions_device) == (
        j.prefix_hits, j.prefix_misses, j.cow_copies,
        j.prefix_evictions_device)
    assert t.cow_copies == 1 and t.prefix_evictions_device == 1
    assert tgen.block_hash_chain(a, 8) == jgen.block_hash_chain(a, 8)
