"""The port's tiered KV (``HostKVPool`` and the tier hooks of
``SlotPagedKVCache``) and its prefill-to-decode handoff
(``export_pages`` / ``import_pages``) against the JAX package's: the
cases of ``tests/test_kv_host_tier.py`` on both caches driven alike,
every counter equal, pages and entries bit-equal (native pages are the
scattered values, int8 ones the shared codec's), and the engines with the
tier on giving the reference's greedy streams."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models import generation as jgen

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import generation as tgen

from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)

#: the tier's counters, on the cache and on its pool
CACHE_COUNTERS = ("host_demotions", "host_promotions", "host_promote_rejects",
                  "prefix_evictions_device", "prefix_hits", "prefix_misses",
                  "cached_tokens_total", "cow_copies", "pages_imported",
                  "pages_exported")
POOL_COUNTERS = ("demotions", "promotions", "hits", "misses", "evictions",
                 "used_bytes", "max_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters(cache):
    out = {n: int(getattr(cache, n)) for n in CACHE_COUNTERS}
    out.update({f"pool.{n}": int(getattr(cache.host_pool, n))
                for n in POOL_COUNTERS})
    out["pool.len"] = len(cache.host_pool)
    return out


class _Pair:
    """A JAX cache and a port cache built alike and driven alike; each
    keys its pools by its own layer object."""

    def __init__(self, max_batch=1, pool_mb=64, **kw):
        kw.setdefault("page_size", 4)
        kw.setdefault("max_len", 32)
        kw.setdefault("num_pages", 9)
        self.j = jgen.SlotPagedKVCache(max_batch,
                                       host_pool=jgen.HostKVPool(pool_mb),
                                       **kw)
        self.t = tgen.SlotPagedKVCache(max_batch,
                                       host_pool=tgen.HostKVPool(pool_mb),
                                       **kw)
        self.jl, self.tl = object(), object()

    def prefill(self, slot, toks, kv, q_seed=0):
        """Admit and prefill the uncached suffix with ``kv`` (each ``[1, n,
        kv, d]``) on both; returns the cached token count (equal)."""
        starts = []
        for c in (self.j, self.t):
            c.assign(slot, toks)
            starts.append(int(c.lens[slot]))
        assert starts[0] == starts[1]
        start = starts[0]
        n = len(toks) - start
        q = np.random.RandomState(q_seed).randn(1, n, 4, kv[0].shape[-1])
        q = q.astype(np.float32)
        k, v = (a[:, start:start + n] for a in kv)
        for c in (self.j, self.t):
            c.begin_prefill(slot, n_valid=n)
        self.j.attend(self.jl, *(Tensor(jnp.asarray(a)) for a in (q, k, v)))
        self.t.attend(self.tl, *(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (q, k, v)))
        self.j.advance(n)
        self.t.end_step()
        for c in (self.j, self.t):
            c.commit_prefix(slot)
        return start

    def both(self, fn):
        return fn(self.j), fn(self.t)

    def evict_all(self):
        for c in (self.j, self.t):
            c.free(0)
            while c._evict_lru():
                pass

    def check_counters(self):
        assert _counters(self.t) == _counters(self.j)


def _page_kv(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, n, 2, 8)).astype(np.float32),
            rng.standard_normal((1, n, 2, 8)).astype(np.float32))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_entry(a, b):
    """Two host entries (or blobs) hold the same bytes."""
    assert a["kv_dtype"] == b["kv_dtype"] and a["page_size"] == b["page_size"]
    assert a["native_dtype"] == b["native_dtype"]
    for group in ("layers", "scales"):
        if a.get(group) is None:
            assert b.get(group) is None
            continue
        for (ka, va), (kb, vb) in zip(a[group], b[group]):
            np.testing.assert_array_equal(_np(ka), _np(kb))
            np.testing.assert_array_equal(_np(va), _np(vb))


# -- demote, then promote -------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_demote_promote_roundtrip_matches_the_reference(kv_dtype):
    """Evicting every index page spills it to the host pool, and the next
    admission promotes the three matchable blocks back: every counter
    equal to the reference's, each entry bit-equal to the reference's,
    and each promoted page bit-equal to the entry it was demoted as
    (int8 pools: codes and scales)."""
    p = _Pair(kv_dtype=kv_dtype)
    toks, kv = np.arange(16), _page_kv(16, 1)
    p.prefill(0, toks, kv)
    snap = {dg: p.t._page_entry(pg) for dg, pg in p.t._index.items()}
    for dg, pg in p.j._index.items():
        _same_entry(snap[dg], p.j._page_entry(pg))
    p.evict_all()
    assert len(p.t._index) == 0 and p.t.host_demotions == len(snap) == 4
    p.check_counters()
    assert p.prefill(0, toks, kv) == 12          # (16 - 1) // 4 blocks
    assert p.t.host_promotions == 3
    p.check_counters()
    for dg, old in snap.items():
        if dg in p.t._index:
            _same_entry(old, p.t._page_entry(int(p.t._index[dg])))
    assert p.t._page_entry(1)["kv_dtype"] == kv_dtype


def test_promotion_moves_the_entry():
    """A promotion takes the entry off the host: the device index holds
    the page again."""
    p = _Pair()
    toks, kv = np.arange(16), _page_kv(16, 2)
    p.prefill(0, toks, kv)
    p.evict_all()
    assert len(p.t.host_pool) == 4
    p.prefill(0, toks, kv)
    assert len(p.t.host_pool) == 4 - p.t.host_promotions == 1
    p.check_counters()


# -- the pool's own LRU bound ---------------------------------------------------

def _entry(width=64):
    return {"page_size": 4, "kv_dtype": "native", "native_dtype": "float32",
            "layers": [(np.zeros((2, 4, width), np.float32),
                        np.zeros((2, 4, width), np.float32))],
            "scales": None}


def test_host_pool_lru_bound_matches_the_reference():
    """Room for three entries: eight puts, a get, one more put; the same
    residents, bytes and counters as the reference's pool after each."""
    per = tgen.HostKVPool.entry_nbytes(_entry())
    assert per == jgen.HostKVPool.entry_nbytes(_entry())
    pools = (jgen.HostKVPool(per * 3 / 2 ** 20),
             tgen.HostKVPool(per * 3 / 2 ** 20))
    for i in range(8):
        assert all(pool.put(bytes([i]), _entry()) for pool in pools)
    for pool in pools:
        assert len(pool) == 3 and pool.evictions == 5
        assert pool.used_bytes <= pool.max_bytes
        assert bytes([4]) not in pool and bytes([5]) in pool
        assert pool.get(bytes([5])) is not None
        assert pool.get(bytes([4])) is None
        pool.put(bytes([8]), _entry())
        assert bytes([5]) in pool and bytes([6]) not in pool
    state = [{n: getattr(pool, n) for n in POOL_COUNTERS}
             | {"keys": list(pool._entries)} for pool in pools]
    assert state[0] == state[1]


def test_oversized_entry_is_dropped_at_once():
    for pool in (jgen.HostKVPool(0.01), tgen.HostKVPool(0.01)):
        assert not pool.put(b"x", _entry(4096))
        assert len(pool) == 0 and pool.used_bytes == 0
        assert pool.demotions == 1 and pool.evictions == 1


def test_pool_of_zero_bytes_is_the_legacy_eviction():
    """``host_pool=None`` (and a pool of 0 MB) is off: an evicted prefix
    is gone, as without a tier, on both caches."""
    p = _Pair(pool_mb=0)
    plain = tgen.SlotPagedKVCache(1, page_size=4, max_len=32, num_pages=9)
    assert not plain.host_pool.enabled and not p.t.host_pool.enabled
    toks, kv = np.arange(16), _page_kv(16, 5)
    p.prefill(0, toks, kv)
    p.evict_all()
    assert p.t.host_demotions == 0 and p.t.prefix_evictions_device == 4
    assert p.prefill(0, toks, kv) == 0
    p.check_counters()


# -- copy-on-write of a promoted page ---------------------------------------------

def test_promoted_page_shared_then_written_copies_on_write():
    """A promoted page is a prefix page like any other: two slots share
    it, a write into the middle of the block copies it first, and the
    index's copy keeps its bytes (the reference's case, on both caches).
    The copy keeps the shared rows before the write. The reference's
    does not (ROADMAP C36): its ``attend`` reads the layer's pools
    (``generation.py:1183``) before its copy-on-write (``:1203``) and
    scatters into those (``:1217``), so that layer's copy is lost and the
    rows before the write read 0. Every other page is equal."""
    p = _Pair(max_batch=2)
    toks = np.arange(12)
    keys = np.broadcast_to(toks.astype(np.float32)[None, :, None, None],
                           (1, 12, 2, 8)).copy()
    p.prefill(0, toks, (keys, keys))
    p.evict_all()
    assert p.t.host_demotions == 3
    p.prefill(0, toks, (keys, keys))
    assert p.t.host_promotions == 2
    p.prefill(1, toks, (keys, keys))
    shared = int(p.t._tables[1, 1])
    assert shared == int(p.t._tables[0, 1]) and p.t._ref[shared] == 3
    new = np.full((1, 2, 2, 8), 100.0, np.float32)
    q = np.zeros((1, 2, 4, 8), np.float32)
    for c in (p.j, p.t):
        c.lens[1] = 6
        c.begin_prefill(1, n_valid=2)
    p.j.attend(p.jl, *(Tensor(jnp.asarray(a)) for a in (q, new, new)))
    p.t.attend(p.tl, *(torch.from_numpy(a) for a in (q, new, new)))
    p.j.advance(2)
    p.t.end_step()
    assert p.t.cow_copies == 1 and int(p.t._tables[1, 1]) != shared
    kp = p.t._pools[id(p.tl)][0]
    assert float(kp[0, shared, 2, 0]) == 6.0             # the index's copy
    copy = int(p.t._tables[1, 1])
    assert copy == int(p.j._tables[1, 1])
    np.testing.assert_array_equal(kp[:, copy, :2].numpy(),
                                  kp[:, shared, :2].numpy())
    assert float(kp[0, copy, 2, 0]) == 100.0
    p.check_counters()
    for a, b in zip(p.j._pools[id(p.jl)], p.t._pools[id(p.tl)]):
        a = np.asarray(a)
        assert np.abs(a[:, copy, :2]).max() == 0.0          # C36
        keep = np.arange(a.shape[1]) != copy
        np.testing.assert_array_equal(b.numpy()[:, keep], a[:, keep])
        np.testing.assert_array_equal(b.numpy()[:, copy, 2:], a[:, copy, 2:])


# -- entries that cannot land -------------------------------------------------------

@pytest.mark.parametrize("corrupt", ["page_size", "kv_dtype", "native_dtype",
                                     "layers"])
def test_mismatched_entry_is_rejected(corrupt):
    """An entry of another page size, KV dtype, pool dtype or layer count
    is dropped at promotion, never written, and the chain walk stops
    there (the first two are the reference's cases; the same counters on
    both caches)."""
    p = _Pair()
    toks = np.arange(16)
    p.prefill(0, toks, _page_kv(16, 4))
    p.evict_all()
    dg = bytes(tgen.block_hash_chain(toks, 4)[0])
    for pool in (p.j.host_pool, p.t.host_pool):
        entry = pool._entries[dg]
        if corrupt == "layers":
            entry["layers"] = entry["layers"] * 2
        else:
            entry[corrupt] = {"page_size": 8, "kv_dtype": "int8",
                              "native_dtype": "float16"}[corrupt]
    assert p.prefill(0, toks, _page_kv(16, 4)) == 0
    assert p.t.host_promote_rejects == 1 and p.t.host_promotions == 0
    assert dg not in p.t.host_pool
    p.check_counters()


def test_exhausted_pool_keeps_the_entry_on_the_host():
    """With every device page held by a live slot, a promotion cannot get
    a page: the entry goes back to the host (a later admission can
    retry) and the walk stops."""
    t = tgen.SlotPagedKVCache(2, page_size=4, max_len=16, num_pages=6,
                              host_pool=tgen.HostKVPool(64))
    layer = object()
    kv = torch.from_numpy(_page_kv(16, 6)[0])

    def fill(slot, toks):
        t.assign(slot, toks)
        start = int(t.lens[slot])
        n = len(toks) - start
        t.begin_prefill(slot, n_valid=n)
        t.attend(layer, torch.zeros(1, n, 4, 8), kv[:, :n], kv[:, :n])
        t.end_step()
        t.commit_prefix(slot)

    fill(0, np.arange(8))
    t.free(0)
    while t._evict_lru():
        pass
    assert len(t.host_pool) == 2
    fill(1, np.arange(100, 116))              # holds four of five pages
    t.assign(0, np.arange(9))                 # needs a page: none is free
    assert t.host_promotions == 1 and len(t.host_pool) == 1
    assert int(t.lens[0]) == 4


# -- the handoff ------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_export_pages_matches_the_reference_and_lands_bit_exact(kv_dtype):
    """After the same load, both caches export the same digests and the
    same arrays (native pages hold the scattered values, int8 ones the
    shared codec's codes and scales); the port's blob lands bit-exact in
    a port cache before its first forward (the backlog, applied as each
    layer's pool is made) and in a warmed one (written in place), and the
    reference's blob lands in a port cache too."""
    p = _Pair(kv_dtype=kv_dtype)
    toks, kv = np.arange(16), _page_kv(16, 7)
    p.prefill(0, toks, kv)
    chain = list(p.t._index)
    jblob, tblob = p.both(lambda c: c.export_pages(chain))
    assert tblob["digests"] == jblob["digests"] == chain
    assert tblob["host_pages"] == jblob["host_pages"] == 0
    _same_entry(jblob, tblob)
    assert tblob["layers"][0][0].shape == (2, 4, 4, 8)

    def receiver(warm):
        dst = _Pair(kv_dtype=kv_dtype)
        if warm:                  # pools made by an unrelated prefill
            dst.prefill(0, np.arange(100, 104), _page_kv(4, 8))
            dst.both(lambda c: c.free(0))
        return dst

    for warm in (False, True):
        for blob in (tblob, jblob):
            dst = receiver(warm)
            assert dst.t.import_pages(blob) == 4
            assert dst.j.import_pages(jblob) == 4
            assert bool(dst.t._import_backlog) != warm
            assert dst.prefill(0, toks, kv) == 12
            dst.check_counters()
            for dg in chain[:3]:
                _same_entry(p.t._page_entry(int(p.t._index[dg])),
                            dst.t._page_entry(int(dst.t._index[dg])))
    assert p.t.pages_exported == 4


def test_export_pages_reads_through_the_host_tier():
    """A demoted chain still hands off, read from the host without a
    promotion (``host_pages``); the lookups count in the pool as the
    reference's do."""
    p = _Pair()
    toks, kv = np.arange(16), _page_kv(16, 8)
    p.prefill(0, toks, kv)
    chain = list(p.t._index)
    p.evict_all()
    jblob, tblob = p.both(lambda c: c.export_pages(chain))
    assert tblob["host_pages"] == jblob["host_pages"] == 4
    _same_entry(jblob, tblob)
    p.check_counters()
    assert p.t.export_pages([b"missing"] + chain) is None


def test_import_pages_rejects_what_cannot_land():
    p = _Pair()
    toks, kv = np.arange(16), _page_kv(16, 9)
    p.prefill(0, toks, kv)
    blob = p.t.export_pages(list(p.t._index))
    bad = {"page_size": dict(blob, page_size=8),
           "kv_dtype": dict(blob, kv_dtype="int8"),
           "native_dtype": dict(blob, native_dtype="float16"),
           "layers": dict(blob, layers=blob["layers"] * 2)}
    says = {"page_size": "page_size", "kv_dtype": "kv_dtype",
            "native_dtype": "pool dtype", "layers": "layer count"}
    for what, b in bad.items():
        with pytest.raises(ValueError, match=says[what]):
            p.t.import_pages(b)
    assert p.t.import_pages(None) == 0


# -- the engines ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(_no_reference_mesh):
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


ENGINE_KW = dict(max_batch_size=1, page_size=4, max_len=32, num_pages=10)


def _prompts():
    rng = np.random.RandomState(7)
    pa = rng.randint(0, 128, (1, 24)).astype(np.int64)
    pb = rng.randint(0, 128, (1, 24)).astype(np.int64)
    return [pa, pb, pa]


def _serve(eng, prompts):
    with eng:
        return [np.asarray(eng.generate(p, max_new_tokens=4, timeout=300))
                for p in prompts]


def test_engine_tier_matches_the_reference(models, monkeypatch):
    """The reference's engine case: three requests through a pool too
    small to keep both prefixes, the host tier on. The third request's
    prefix is promoted from the host; the port's greedy streams equal
    the reference engine's and the tier's counters equal its counters.
    The reference's ragged attention runs its XLA tier (its interpret
    kernel takes seconds a tick on the CPU)."""
    jm, tm = models
    prompts = _prompts()
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "xla")
    jeng = JaxEngine(jm, **ENGINE_KW, host_pool_mb=64)
    want = _serve(jeng, prompts)
    teng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW,
                                      host_pool_mb=64)
    got = _serve(teng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teng.host_promotions == jeng._cache.host_promotions > 0
    assert _counters(teng._cache) == _counters(jeng._cache)
    assert teng._cache.host_pool is teng._host_pool


@pytest.mark.parametrize("enable_ragged", [True, False])
def test_engine_tier_keeps_generate_streams(models, enable_ragged):
    """Tier on or off, on either scheduler, the streams are ``generate``'s;
    only the tier-on engine promotes."""
    _, tm = models
    prompts = _prompts()
    wants = [tm.generate(torch.from_numpy(p), max_new_tokens=4).numpy()
             for p in prompts]
    for mb in (0, 64):
        eng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW,
                                         host_pool_mb=mb,
                                         enable_ragged=enable_ragged)
        for g, w in zip(_serve(eng, prompts), wants):
            np.testing.assert_array_equal(g, w)
        assert (eng.host_promotions > 0) == bool(mb)
        assert (eng._host_pool.demotions > 0) == bool(mb)


def test_engine_validation_and_warmup(models):
    _, tm = models
    with pytest.raises(ValueError):
        pt.ContinuousServingEngine(tm, device="cpu", host_pool_mb=-1)
    eng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW,
                                     host_pool_mb=8)
    assert eng._host_pool.max_bytes == 8 * 2 ** 20
    out = eng.warmup_programs()
    assert set(out) == {"serving.ragged", "kv.host_promote"}
    assert len(eng._host_pool) == 0          # the scratch pool took it
    off = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW)
    assert "kv.host_promote" not in off.warmup_programs()


def test_handoff_between_engines_serves_the_imported_prefix(models,
                                                            monkeypatch):
    """Export the shared chain from an engine's cache, the port's and the
    reference's (the same digests, K/V within 1e-5), and import each blob
    into a fresh port engine before its first forward (the backlog) and
    into a warmed one: all serve the sharing prompt with prefix hits
    equal to the imported pages and the stream of the engines that
    computed the prefix themselves, the reference's included."""
    jm, tm = models
    kw = dict(ENGINE_KW, max_len=64, num_pages=17)
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, 128, 20)
    first = np.concatenate([prefix, rng.randint(0, 128, 3)])[None]
    second = np.concatenate([prefix, rng.randint(0, 128, 5)])[None]
    chain = tgen.block_hash_chain(second[0], 4)[:5]
    src = pt.ContinuousServingEngine(tm, device="cpu", **kw)
    want = _serve(src, [first, second])[1]
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "xla")
    jsrc = JaxEngine(jm, **kw)
    np.testing.assert_array_equal(_serve(jsrc, [first, second])[1], want)
    blobs = {"port": src._cache.export_pages(chain),
             "reference": jsrc._cache.export_pages(chain)}
    # the two models compute K/V with other summation orders: the slice's
    # 1e-5, not bits
    for (k, v), (jk, jv) in zip(blobs["port"]["layers"],
                                blobs["reference"]["layers"]):
        np.testing.assert_allclose(k, np.asarray(jk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-5)
    for name, blob in blobs.items():
        assert blob["digests"] == chain
        for warm in (False, True):
            dst = pt.ContinuousServingEngine(tm, device="cpu", **kw)
            if warm:
                _serve(dst, [rng.randint(0, 128, (1, 9))])
            cache = dst._cache if warm else dst._new_cache()
            dst._adopt = cache
            assert cache.import_pages(blob) == 5
            got = _serve(dst, [second])[0]
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert dst.prefix_hits == 5
