"""Speculative decoding in the port against ``paddle_tpu`` on the CPU.

The drafters (prompt lookup and the draft model, per sequence and
batched), ``SlotPagedKVCache.rollback`` (tables, refcounts, free pages
and counters after the same operations as the reference's cache), and
the continuous engine with ``spec_decode=True``: greedy streams equal to
spec off, to the reference engine's spec-on streams and to ``generate``,
with the reference's speculation counters, for the self-drafting model,
the n-gram drafter and a drafter that is always wrong; seeded sampling
with spec equal to seeded sampling without it (within the port, ROADMAP
C2); int8 pools, the per-token grid and the q-block grid's fixed shape
under verify spans. Weights come from the JAX model through
``convert.load_jax_state``.
"""
import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models.generation import SlotPagedKVCache as JaxCache

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import (DraftModelDrafter, NGramDrafter,
                                        make_drafter)
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models.generation import SlotPagedKVCache
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


def _load(name):
    """A sibling test module, loaded by path (``tests/`` is no package)."""
    path = Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FINISH = _load("test_torch_serving_finish.py")

#: the reference test's engine (tests/test_speculative.py:_run_workload)
ENGINE_KW = dict(max_batch_size=4, max_len=96, page_size=16,
                 prefill_chunk_tokens=24, token_budget=32)
NEW = 8
SPEC_COUNTERS = ("spec_drafted_tokens", "spec_accepted_tokens",
                 "spec_rounds", "spec_draft_ticks", "ragged_steps",
                 "decode_steps", "ragged_decode_tokens",
                 "ragged_prefill_tokens", "cancelled_rows")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(_no_reference_mesh):  # noqa: F811
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2, max_position_embeddings=256))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2,
                                           max_position_embeddings=256),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


class _WrongDrafter:
    """Proposes the history's last token k times: the target rejects
    what does not match, and the rejected tail rolls back."""

    def propose(self, history, k):
        return [int(history[-1])] * int(k) if k > 0 else []


def _mixed_prompts():
    """The reference test's load: 8 prompts sharing a 48-token prefix."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 128, 48)
    return [np.concatenate([shared, rng.randint(0, 128, t)])
            .astype(np.int64)[None] for t in (3, 9, 5, 14, 7, 4, 11, 6)]


def _requests(prompts, **kw):
    return [(p, dict(max_new_tokens=NEW, **kw)) for p in prompts]


def _port(tm, **kw):
    return pt.ContinuousServingEngine(tm, device="cpu",
                                      **dict(ENGINE_KW, **kw))


def _counters(eng):
    return {name: getattr(eng, name) for name in SPEC_COUNTERS}


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

#: the reference test's histories and asks, then random ones
HISTORIES = [([5, 6, 7, 9, 1, 5, 6, 7], 3), ([5, 6, 7, 9, 1, 5, 6, 7], 1),
             ([1, 2, 3, 4], 3), ([7], 3), ([5, 6, 7, 9, 1, 5, 6, 7], 0),
             ([2, 9, 8, 7, 2, 3, 1, 2], 2)] + [
    (np.random.RandomState(s).randint(0, 6, 3 + 5 * s).tolist(), 1 + s % 5)
    for s in range(12)]


@pytest.mark.parametrize("max_ngram", [1, 2, 3, 5])
def test_ngram_drafter_matches_reference(max_ngram):
    ours, ref = NGramDrafter(max_ngram), jspec.NGramDrafter(max_ngram)
    for hist, k in HISTORIES:
        assert ours.propose(hist, k) == ref.propose(hist, k), (hist, k)
    d = NGramDrafter(max_ngram=3)
    assert d.propose([5, 6, 7, 9, 1, 5, 6, 7], 3) == [9, 1, 5]
    assert d.propose([2, 9, 8, 7, 2, 3, 1, 2], 2) == [3, 1]


def test_pow2_bucket_matches_reference():
    for n in range(0, 70):
        for cap in (None, 1, 8, 64):
            assert tspec._pow2_bucket(n, cap) == jspec._pow2_bucket(n, cap)


def test_make_drafter(models):
    _, tm = models
    assert isinstance(make_drafter(), NGramDrafter)
    assert make_drafter().max_ngram == tspec.DEFAULT_SPEC_NGRAM == 3
    assert isinstance(make_drafter(draft_model=tm), DraftModelDrafter)
    assert make_drafter("ngram", max_ngram=5).max_ngram == 5
    assert make_drafter("model", draft_model=tm, window=32).window == 32
    with pytest.raises(ValueError):
        make_drafter("model")
    with pytest.raises(ValueError):
        make_drafter("warp")
    assert tspec.DEFAULT_SPEC_K == jspec.DEFAULT_SPEC_K == 4


def _draft_histories():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 128, n).astype(np.int64) for n in (12, 3, 40, 70)]


def test_draft_model_propose_matches_reference(models):
    jm, tm = models
    ours = DraftModelDrafter(tm, window=64)
    ref = jspec.DraftModelDrafter(jm, window=64)
    for h in _draft_histories():
        assert ours.propose(h, 3) == ref.propose(h, 3)
    assert ours.forwards == ref.forwards == 12
    assert ours.propose(_draft_histories()[0], 0) == []
    # the drafts of the target model itself are generate's greedy tokens
    h = _draft_histories()[0]
    want = tm.generate(torch.as_tensor(h[None]), max_new_tokens=3)
    assert ours.propose(h, 3) == want[0, -3:].tolist()


def test_draft_model_batch_matches_reference_and_propose(models):
    jm, tm = models
    ks = [3, 0, 2, 4]
    ours = DraftModelDrafter(tm, window=64)
    got = ours.propose_batch(_draft_histories(), ks)
    want = jspec.DraftModelDrafter(jm, window=64).propose_batch(
        _draft_histories(), ks)
    assert got == want
    # one padded forward a draft step, not one a sequence
    assert ours.forwards == max(ks)
    single = DraftModelDrafter(tm, window=64)
    assert got == [single.propose(h, k)
                   for h, k in zip(_draft_histories(), ks)]
    assert ours.propose_batch([[], [1, 2]], [0, 0]) == [[], []]


def test_draft_batch_shapes_are_bucketed(models):
    _, tm = models
    d = DraftModelDrafter(tm, window=32)
    shapes = []
    forward = tm.forward

    def spy(ids, *a, **kw):
        shapes.append(tuple(np.shape(ids)))
        return forward(ids, *a, **kw)
    tm.forward = spy
    try:
        d.propose_batch(_draft_histories()[:3], [2, 1, 2])
    finally:
        del tm.forward
    # 3 rows at width 32 (the 40-token history cut to the window), then
    # the 2 rows still drafting
    assert shapes == [(4, 32), (2, 32)]


# ---------------------------------------------------------------------------
# rollback: the reference cache's state after the same operations
# ---------------------------------------------------------------------------

def _state(c):
    return dict(tables=np.asarray(c._tables).copy(),
                ref=np.asarray(c._ref).copy(), free=c.free_page_count,
                lens=np.asarray(c.lens).copy(),
                blocks=np.asarray(c._n_blocks).copy(),
                rollbacks=c.rollbacks, rolled=c.tokens_rolled_back,
                index=dict(c._index))


def _assert_same(a, b):
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def _lifecycle(c, case):
    """One rollback scenario at page 4 on cache ``c`` (either package);
    returns the states after each step."""
    states = []
    c._ensure_blocks(0, 10)                   # 3 blocks
    c.lens[0] = 10
    if case == "private":
        states.append(c.rollback(0, 5))       # keep 5 tokens, 2 blocks
        states.append(c.rollback(0, 0))
    elif case == "cow_shared":
        shared = int(c._tables[0, 1])
        c._tables[1, 0] = shared              # slot 1 aliases block 1
        c._ref[shared] += 1
        c._n_blocks[1] = 1
        c.lens[1] = 4
        states.append(c.rollback(0, 7))       # truncates past the share
        states.append(c.rollback(1, 4))       # the last reference goes
    elif case == "prefix_registered":
        page = int(c._tables[0, 1])
        digest = b"\x01" * 20
        c._index[digest] = page               # register block 1
        c._page_digest[page] = digest
        c._ref[page] += 1                     # the index's own reference
        states.append(c.rollback(0, 10))      # the whole slot
        states.append(_state(c))
        assert c._evict_lru()                 # then evictable as usual
    states.append(_state(c))
    with pytest.raises(ValueError):
        c.rollback(0, int(c.lens[0]) + 1)
    return states


@pytest.mark.parametrize("case", ["private", "cow_shared",
                                  "prefix_registered"])
def test_rollback_lifecycle_matches_reference(case):
    ours = _lifecycle(SlotPagedKVCache(2, page_size=4, max_len=32), case)
    ref = _lifecycle(JaxCache(2, page_size=4, max_len=32), case)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(a, dict):
            _assert_same(a, b)
        else:
            assert a == b


def test_rollback_frees_private_pages_and_counts():
    c = SlotPagedKVCache(2, page_size=4, max_len=32)
    c._ensure_blocks(0, 10)
    c.lens[0] = 10
    free0 = c.free_page_count
    last = int(c._tables[0, 2])
    assert c.rollback(0, 5) == 5
    assert int(c.lens[0]) == 5 and int(c._n_blocks[0]) == 2
    assert c.free_page_count == free0 + 1 and last in c._free
    assert c._tables[0, 2] == 0
    assert c.rollbacks == 1 and c.tokens_rolled_back == 5


def test_rollback_restages_the_device_tables():
    """After a rollback the next tick's staged block table and q-block
    schedule hold no unmapped page: ``begin_ragged`` refills them from the
    host tables."""
    c = SlotPagedKVCache(2, page_size=4, max_len=32)
    c.assign(0, np.arange(10))
    c.begin_ragged([(0, 0, 10)], num_tokens=16)
    c.end_step()
    pages = c._tables[0, :3].copy()
    c.rollback(0, 5)                          # block 2 leaves the table
    c.begin_ragged([(0, 0, 1)], num_tokens=16)
    page_ids, slot_ids, tables, _, plan = c._idx
    assert (tables[0, 2:] == 0).all()
    b, s, j0, n = plan.host["units"][0]        # block 0's slot-0 unit
    # the unit walks the kept pages only: ctx 6 is two pages
    assert plan.host["job_page"][b, j0:j0 + n].tolist() == pages[:2].tolist()
    # the one new token is written at position 5, inside block 1
    assert int(page_ids[0]) == pages[1] and int(slot_ids[0]) == 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_spec_needs_the_ragged_scheduler(models):
    _, tm = models
    with pytest.raises(ValueError):
        _port(tm, spec_decode=True, enable_ragged=False)
    eng = _port(tm)
    assert eng.enable_spec is False and eng._drafter is None
    assert eng.declared_draft_buckets() is None
    eng = _port(tm, spec_decode=True)
    assert eng.spec_k == tspec.DEFAULT_SPEC_K
    assert isinstance(eng._drafter, NGramDrafter)
    assert eng.declared_draft_buckets() is None     # no batch path
    eng = _port(tm, spec_decode=True, spec_k=2, draft_model=tm)
    assert eng.spec_k == 2 and isinstance(eng._drafter, DraftModelDrafter)


def test_declared_draft_buckets_match_reference(models):
    jm, tm = models
    for slots in (1, 3, 4, 8):
        ref = JaxEngine(jm, max_batch_size=slots, spec_decode=True,
                        draft_model=jm).declared_draft_buckets()
        ours = pt.ContinuousServingEngine(
            tm, device="cpu", max_batch_size=slots, spec_decode=True,
            draft_model=tm).declared_draft_buckets()
        assert ours == ref
    assert pt.ContinuousServingEngine(
        tm, device="cpu", spec_decode=True, draft_model=tm,
        draft_batch=False).declared_draft_buckets() is None


def test_warmup_runs_every_declared_draft_bucket(models):
    _, tm = models
    eng = _port(tm, spec_decode=True, draft_model=tm)
    rows, widths = eng.declared_draft_buckets()
    shapes = []
    forward = tm.forward

    def spy(ids, *a, **kw):
        shapes.append(tuple(np.shape(ids)))
        return forward(ids, *a, **kw)
    tm.forward = spy
    try:
        out = eng.warmup_programs(("spec.draft_batch",))
    finally:
        del tm.forward
    assert set(out) == {"spec.draft_batch"}
    assert sorted(shapes) == sorted((r, w) for r in rows for w in widths)
    assert eng._drafter.forwards == 0          # warm-up counts nothing


@pytest.fixture(scope="module")
def jax_spec(models):
    """The mixed load with a cancelled request through the JAX engine,
    spec on (the self-drafting model, the reference test's setting) and
    with the n-gram drafter: outputs and counters."""
    jm, _ = models
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    try:
        for name, kw in (("self", dict(draft_model=jm)), ("ngram", {})):
            eng = JaxEngine(jm, spec_decode=True, spec_k=3, **ENGINE_KW,
                            **kw)
            outs = FINISH._drive(eng, _requests(_mixed_prompts()),
                                 cancelled=True)
            out[name] = dict(outs=outs, counters=_counters(eng))
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def spec_off(models):
    _, tm = models
    eng = _port(tm)
    return FINISH._drive(eng, _requests(_mixed_prompts()), cancelled=True)


@pytest.mark.parametrize("drafter", ["self", "ngram"])
def test_spec_streams_and_counters_match_reference(models, jax_spec,
                                                   spec_off, drafter):
    _, tm = models
    kw = dict(draft_model=tm) if drafter == "self" else {}
    eng = _port(tm, spec_decode=True, spec_k=3, **kw)
    outs = FINISH._drive(eng, _requests(_mixed_prompts()), cancelled=True)
    want = jax_spec[drafter]
    for got, ref, off in zip(outs, want["outs"], spec_off):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, off)
    assert _counters(eng) == want["counters"]
    assert eng.spec_drafted_tokens > 0 and eng.spec_accepted_tokens > 0
    assert eng._cache.prefix_hits > 0
    if drafter == "self":
        # the reference test's bar: acceptance > 0.9 and fewer target
        # forwards than generated tokens
        assert eng.spec_accepted_tokens / eng.spec_drafted_tokens > 0.9
        assert eng.decode_steps < NEW * len(outs)
        assert eng.spec_draft_forwards > 0


def test_spec_streams_equal_generate(models, spec_off):
    _, tm = models
    for p, got in zip(_mixed_prompts()[:3], spec_off[:3]):
        want = tm.generate(torch.as_tensor(p), max_new_tokens=NEW)
        np.testing.assert_array_equal(got, want.numpy())


def test_spec_staggered_arrivals_and_cancellation(models, spec_off):
    """The reference test's driving: requests arrive on their own threads
    10 ms apart while one client gives up. Greedy streams are spec off's
    whatever the ticks hold."""
    _, tm = models
    prompts = _mixed_prompts()
    eng = _port(tm, spec_decode=True, spec_k=3, draft_model=tm)
    results = [None] * len(prompts)
    with eng:
        results[0] = eng.generate(prompts[0], max_new_tokens=NEW,
                                  timeout=300).numpy()

        def call(i):
            time.sleep(0.01 * i)
            results[i] = eng.generate(prompts[i], max_new_tokens=NEW,
                                      timeout=300).numpy()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(1, len(prompts))]
        for t in threads:
            t.start()
        with pytest.raises(TimeoutError):
            eng.generate(prompts[0], max_new_tokens=30, timeout=0.001)
        for t in threads:
            t.join(300)
        deadline = time.time() + 60
        while eng.cancelled_rows < 1 and time.time() < deadline:
            time.sleep(0.01)
    assert eng.cancelled_rows >= 1
    for got, off in zip(results, spec_off):
        np.testing.assert_array_equal(got, off)
    assert eng.spec_accepted_tokens > 0


def test_always_wrong_drafter_rolls_back(models):
    _, tm = models
    p = np.random.RandomState(1).randint(0, 128, (1, 20)).astype(np.int64)
    want = tm.generate(torch.as_tensor(p), max_new_tokens=6).numpy()
    eng = pt.ContinuousServingEngine(tm, device="cpu", max_batch_size=2,
                                     max_len=64, token_budget=16,
                                     spec_decode=True, spec_k=3,
                                     drafter=_WrongDrafter())
    with eng:
        got = eng.generate(p, max_new_tokens=6, timeout=300).numpy()
    np.testing.assert_array_equal(got, want)
    assert eng.spec_drafted_tokens > 0
    assert eng._cache.rollbacks > 0
    assert eng._cache.tokens_rolled_back >= eng.spec_drafted_tokens \
        - eng.spec_accepted_tokens


def test_seeded_sampling_with_spec_equals_without(models):
    _, tm = models
    p = np.random.RandomState(4).randint(0, 128, (1, 16)).astype(np.int64)

    def run(**kw):
        eng = pt.ContinuousServingEngine(tm, device="cpu", max_batch_size=2,
                                         max_len=64, token_budget=16, **kw)
        with eng:
            return eng.generate(p, max_new_tokens=8, do_sample=True,
                                temperature=1.3, seed=11,
                                timeout=300).numpy(), eng

    off, _ = run()
    on, eng = run(spec_decode=True, spec_k=3, draft_model=tm)
    np.testing.assert_array_equal(on, off)
    assert eng.spec_drafted_tokens > 0
    wrong, eng = run(spec_decode=True, spec_k=3, drafter=_WrongDrafter())
    np.testing.assert_array_equal(wrong, off)
    assert eng._cache.rollbacks > 0


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(ragged_impl="token"),
                                dict(draft_batch=False)],
                         ids=["int8_pools", "per_token", "unbatched"])
def test_spec_on_other_engines_equals_spec_off(models, kw):
    _, tm = models
    prompts = _mixed_prompts()[:4]
    off = FINISH._drive(_port(tm, **kw), _requests(prompts))
    eng = _port(tm, spec_decode=True, spec_k=3, draft_model=tm, **kw)
    on = FINISH._drive(eng, _requests(prompts))
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert eng.spec_accepted_tokens > 0


def test_spec_with_max_length_eos_and_abort(models):
    """Emission stops at ``eos_token_id`` and at ``max_length`` inside a
    verify span; ``abort`` fails every request of a speculating engine."""
    _, tm = models
    p = _mixed_prompts()[1]
    full = tm.generate(torch.as_tensor(p), max_new_tokens=NEW).numpy()
    eos = int(full[0, p.shape[1] + 2])
    eng = _port(tm, spec_decode=True, spec_k=4, draft_model=tm)
    with eng:
        got = eng.generate(p, max_new_tokens=NEW, eos_token_id=eos,
                           timeout=300).numpy()
        short = eng.generate(p, max_length=p.shape[1] + 3,
                             timeout=300).numpy()
    stop = list(full[0, p.shape[1]:]).index(eos) + 1
    np.testing.assert_array_equal(got[0, :p.shape[1] + stop],
                                  full[0, :p.shape[1] + stop])
    assert (got[0, p.shape[1] + stop:] == eos).all()
    np.testing.assert_array_equal(short, full[:, :p.shape[1] + 3])
    # abort under load: the speculating row in flight and the queued one
    # fail, their slots freed
    eng = _port(tm, spec_decode=True, spec_k=4, draft_model=tm,
                max_batch_size=1)
    errors = FINISH._abort_under_load(
        eng, lambda e: e.decode_steps + e.prefill_chunks)
    assert [str(e) for e in errors] == ["ServingEngine aborted"] * 2
    assert (eng._cache.lens == 0).all() and (eng._cache._n_blocks == 0).all()


def test_verify_spans_fit_the_fixed_qblock_grid(models):
    """Every tick of a speculating engine plans within its bucket's fixed
    grid: the staged plans' unit and job counts never pass
    ``qblock_caps``."""
    _, tm = models
    from paddle_tpu_torch.ops import ragged_paged_attention as trpa
    eng = _port(tm, spec_decode=True, spec_k=4, draft_model=tm)
    seen = []
    plan_arrays = trpa.plan_arrays

    def spy(num_tokens, *args, **kw):
        out = plan_arrays(num_tokens, *args, **kw)
        seen.append((num_tokens, int(out["n_units"][0]),
                     out["units"].shape[0], out["job_page"].shape[1]))
        return out
    from paddle_tpu_torch.models import generation
    generation.plan_arrays = spy
    try:
        FINISH._drive(eng, _requests(_mixed_prompts()))
    finally:
        generation.plan_arrays = plan_arrays
    assert seen and eng.spec_rounds > 0
    for tokens, live, u_max, j_max in seen:
        caps = trpa.qblock_caps(tokens, trpa.DEFAULT_QBLOCK,
                                ENGINE_KW["max_batch_size"],
                                -(-ENGINE_KW["max_len"]
                                  // ENGINE_KW["page_size"]))
        assert live <= u_max == caps[0] and j_max == caps[1]
