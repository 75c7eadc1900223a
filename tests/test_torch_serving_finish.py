"""The continuous engine's finished surface against the JAX engine, on a
two-layer fp32 model with the JAX model's weights: every engine counter
and the ``events`` sequence on one load, ``max_length`` and the zero
budget, ``abort`` (queued and in-flight requests fail, ``start()`` serves
again), the declared tick buckets and program families, and
``top_k=1`` sampling against the JAX engine's greedy stream. Seeded
sampling reproduces within the port (JAX keys cannot be reproduced in
torch, ROADMAP C2): the same seed gives the same stream whatever the
scheduler and whatever the request shares its ticks with. Plus
``warmup_programs`` and the q-block kernels' fixed grid: the plain
version on a plan padded to ``U_max`` / ``J_max`` gives the unpadded
plan's bits."""
import importlib.util
import math
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.profiler import compile_observatory as jco

import paddle_tpu_torch as pt
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.ops import ragged_paged_attention as trpa
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


def _load(name):
    """A sibling test module, loaded by path (``tests/`` is no package)."""
    path = Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


UNITS = _load("test_torch_ragged_qblock_units.py")

ENGINE_KW = dict(max_batch_size=4, max_len=64, token_budget=16,
                 prefill_chunk_tokens=16)
NEW = 5
COUNTERS = ("decode_steps", "prefills", "prefill_chunks", "cancelled_rows",
            "ragged_steps", "ragged_prefill_tokens", "ragged_decode_tokens",
            "padded_tokens_total", "useful_tokens_total")
SCHEDULERS = {"qblock": dict(ragged_impl="qblock"),
              "token": dict(ragged_impl="token"),
              "legacy": dict(enable_ragged=False)}
SAMPLED = dict(do_sample=True, temperature=1.3, seed=7)


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


def _prompts():
    """Four unrelated prompts, two sharing a 33-token prefix (two full
    16-token blocks), and one whose request gives ``max_length``."""
    rng = np.random.RandomState(1)
    base = [rng.randint(0, 128, (1, n)).astype(np.int64)
            for n in (23, 5, 37, 11)]
    prefix = rng.randint(0, 128, 33)
    shared = [np.concatenate([prefix, rng.randint(0, 128, n)])[None]
              .astype(np.int64) for n in (7, 4)]
    return [shared[0]] + base + [shared[1]]


def _held(eng):
    """Hold the serve loop at a tick boundary; returns the release
    event and the holder thread."""
    entered, release = threading.Event(), threading.Event()

    def hold(_):
        entered.set()
        release.wait(60)

    holder = threading.Thread(target=lambda: eng.run_on_loop(hold, 60))
    holder.start()
    assert entered.wait(60)
    return release, holder


def _submit(eng, fn):
    """Start ``fn`` on a thread once the queue grew by its request."""
    n = eng._q.qsize()
    t = threading.Thread(target=fn)
    t.start()
    deadline = time.monotonic() + 30
    while eng._q.qsize() == n and time.monotonic() < deadline:
        time.sleep(0.001)
    return t


def _drive(eng, requests, cancelled=False, before=None):
    """Submit ``requests`` (``(prompt, generate kwargs)``) one at a time
    while the serve loop is held, so that every engine admits the same
    rows on the same tick; with ``cancelled`` a first request times out
    in the queue before the loop is released (admission drops its row).
    ``before(engine)`` runs on the serve loop first. Returns the
    outputs."""
    results = [None] * len(requests)
    with eng:
        if before is not None:
            eng.run_on_loop(before, 300)
        release, holder = _held(eng)
        threads = []
        if cancelled:
            timed_out = []

            def late():
                try:
                    eng.generate(requests[0][0], max_new_tokens=NEW,
                                 timeout=0.2)
                except TimeoutError as e:
                    timed_out.append(e)
            t = _submit(eng, late)
            t.join(30)
            assert not t.is_alive() and timed_out
        for i, (p, kw) in enumerate(requests):
            def run(i=i, p=p, kw=kw):
                results[i] = np.asarray(eng.generate(p, timeout=300, **kw))
            threads.append(_submit(eng, run))
        release.set()
        for t in threads + [holder]:
            t.join(300)
            assert not t.is_alive()
    return results


def _load_requests(**kw):
    """The shared load: every prompt with ``NEW`` new tokens, the fourth
    with ``max_length`` instead (three new tokens)."""
    reqs = [(p, dict(max_new_tokens=NEW, **kw)) for p in _prompts()]
    p = reqs[3][0]
    reqs[3] = (p, dict(max_length=p.shape[1] + 3, **kw))
    return reqs


def _counters(eng):
    return {name: getattr(eng, name) for name in COUNTERS}


@pytest.fixture(scope="module")
def jax_runs(models):
    """The shared load through the JAX engine on both schedulers (the
    q-block grid for the ragged one), with one cancelled request:
    outputs, counters, events, bucket sets, free pages."""
    jm, _ = models
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    try:
        for name, ragged in (("ragged", True), ("legacy", False)):
            eng = JaxEngine(jm, enable_ragged=ragged, **ENGINE_KW)
            outs = _drive(eng, _load_requests(), cancelled=True)
            out[name] = dict(outs=outs, counters=_counters(eng),
                             events=list(eng.events),
                             buckets=set(eng.ragged_buckets_used),
                             free=eng._cache.free_page_count)
    finally:
        mp.undo()
    return out


def _port(tm, scheduler, **kw):
    return pt.ContinuousServingEngine(tm, device="cpu",
                                      **SCHEDULERS[scheduler],
                                      **dict(ENGINE_KW, **kw))


# ---------------------------------------------------------------------------
# counters, events, max_length: the port against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["qblock", "legacy"])
def test_counters_and_events_match_jax(models, jax_runs, scheduler):
    _, tm = models
    want = jax_runs["legacy" if scheduler == "legacy" else "ragged"]
    eng = _port(tm, scheduler)
    outs = _drive(eng, _load_requests(), cancelled=True)
    for w, g in zip(want["outs"], outs):
        np.testing.assert_array_equal(g, w)
    assert _counters(eng) == want["counters"]
    assert eng.cancelled_rows == 1 and eng.prefills == len(outs)
    assert list(eng.events) == want["events"]
    assert eng.events.maxlen == 4096
    assert eng.ragged_buckets_used == want["buckets"]
    assert eng._cache.free_page_count == want["free"]
    if scheduler == "qblock":
        # the ragged tick counts a chunk per prefill span and a decode
        # step per tick with decode rows, as the reference's does
        assert eng.prefill_chunks > 0 and eng.decode_steps > 0
        assert eng.ragged_prefill_tokens + eng.ragged_decode_tokens \
            == eng.useful_tokens_total


def test_max_length_and_zero_budget_match_jax(models, jax_runs):
    jm, tm = models
    p = _prompts()[3]
    # the shared load's fourth request gave max_length = prompt + 3
    assert jax_runs["ragged"]["outs"][3].shape == (1, p.shape[1] + 3)
    jeng = JaxEngine(jm, **ENGINE_KW)
    teng = _port(tm, "qblock")
    for kw in (dict(max_new_tokens=0), dict(max_length=p.shape[1]),
               dict(max_length=p.shape[1] - 2, max_new_tokens=9)):
        want = np.asarray(jeng.generate(p, **kw).numpy())
        got = np.asarray(teng.generate(p, **kw))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, p)


# ---------------------------------------------------------------------------
# seeded sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["qblock", "legacy"])
def test_top_k_1_sampling_equals_jax_greedy(models, jax_runs, scheduler):
    """``top_k=1`` keeps only the argmax, so a sampled stream is the
    greedy one, bit for bit against the JAX engine's."""
    _, tm = models
    want = jax_runs["legacy" if scheduler == "legacy" else "ragged"]["outs"]
    got = _drive(_port(tm, scheduler),
                 _load_requests(do_sample=True, top_k=1, seed=3))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _sampled_rows():
    """One two-row request (the same prompt twice: the rows draw with
    their own row index) and its prompt."""
    p = np.random.RandomState(3).randint(0, 128, 16).astype(np.int64)
    return np.stack([p, p])


def test_seeded_sampling_reproduces_and_seeds_diverge(models):
    _, tm = models
    ids = _sampled_rows()

    def run(seed):
        eng = _port(tm, "qblock")
        with eng:
            return np.asarray(eng.generate(
                ids, max_new_tokens=8, timeout=300,
                **dict(SAMPLED, seed=seed)))

    a, b, c = run(7), run(7), run(8)
    assert a.shape == (2, 24)
    np.testing.assert_array_equal(a, b)          # same seed, same text
    assert not np.array_equal(a, c)               # another seed diverges
    # the row index is part of the draw: identical rows differ
    assert not np.array_equal(a[0], a[1])


@pytest.fixture(scope="module")
def sampled_alone(models):
    """The seeded two-row request alone on the q-block engine."""
    _, tm = models
    eng = _port(tm, "qblock")
    with eng:
        return np.asarray(eng.generate(_sampled_rows(), max_new_tokens=8,
                                       timeout=300, **SAMPLED))


@pytest.mark.parametrize("company", ["alone", "co-scheduled"])
@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_seeded_stream_independent_of_scheduler_and_company(
        models, sampled_alone, scheduler, company):
    """A seeded token is a function of its logits row, the seed, the row
    index and the token index: the q-block grid, the per-token grid and
    the legacy scheduler give the stream the q-block engine gave the
    request alone, and so they do with other requests (greedy and
    sampled, with other seeds) in its ticks."""
    _, tm = models
    ids = _sampled_rows()
    reqs = [(ids, dict(max_new_tokens=8, **SAMPLED))]
    if company == "co-scheduled":
        others = _prompts()[:3]
        reqs = [(others[0], dict(max_new_tokens=NEW)),
                (others[1], dict(max_new_tokens=NEW, do_sample=True,
                                 seed=11)),
                reqs[0],
                (others[2], dict(max_new_tokens=NEW, do_sample=True,
                                 top_p=0.9, seed=12))]
    outs = _drive(_port(tm, scheduler), reqs)
    got = outs[0] if company == "alone" else outs[2]
    np.testing.assert_array_equal(got, sampled_alone)


def test_generate_rejects_unknown_options(models):
    _, tm = models
    eng = _port(tm, "qblock")
    with pytest.raises(TypeError, match="num_beams"):
        eng.generate(np.zeros(4, np.int64), max_new_tokens=2, num_beams=2)
    assert set(tserving.SAMPLING_OPTIONS) == {
        "do_sample", "top_k", "top_p", "temperature", "seed",
        "eos_token_id"}


# ---------------------------------------------------------------------------
# abort
# ---------------------------------------------------------------------------

def _abort_under_load(eng, progress):
    """One slot: request A runs (64 new tokens) while B waits in the
    queue; once A's first forward ran, ``abort()``. Returns both errors."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 128, (1, 16)).astype(np.int64)
               for _ in range(2)]
    errors = [None, None]
    eng.start()
    release, holder = _held(eng)
    threads = []
    for i, p in enumerate(prompts):
        def run(i=i, p=p):
            try:
                eng.generate(p, max_new_tokens=40, timeout=600)
            except RuntimeError as e:
                errors[i] = e
        threads.append(_submit(eng, run))
    release.set()
    holder.join(60)
    deadline = time.monotonic() + 60
    while progress(eng) == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert progress(eng) > 0
    eng.abort()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return errors


@pytest.mark.parametrize("ragged", [True, False])
def test_abort_fails_inflight_and_queued_like_jax(models, ragged):
    jm, tm = models
    kw = dict(ENGINE_KW, max_batch_size=1, max_len=96,
              enable_ragged=ragged)

    def progress(eng):
        return eng.decode_steps + eng.prefill_chunks

    jerrs = _abort_under_load(JaxEngine(jm, **kw), progress)
    eng = pt.ContinuousServingEngine(tm, device="cpu", **kw)
    terrs = _abort_under_load(eng, progress)
    for errs in (jerrs, terrs):
        assert all(e is not None and "aborted" in str(e) for e in errs), errs
    assert [str(e) for e in terrs] == [str(e) for e in jerrs]
    # the aborted rows' slots were freed
    assert (eng._cache.lens == 0).all() and (eng._cache._n_blocks == 0).all()
    # start() serves again, a fresh cache, the stream of a fresh engine
    p = np.random.RandomState(5).randint(0, 128, 9).astype(np.int64)
    with eng:
        got = np.asarray(eng.generate(p, max_new_tokens=4, timeout=300))
    with pt.ContinuousServingEngine(tm, device="cpu", **kw) as fresh:
        want = np.asarray(fresh.generate(p, max_new_tokens=4, timeout=300))
    np.testing.assert_array_equal(got, want)


def test_static_engine_abort_fails_batch_and_queue(models):
    """The static engine's tick is one batch: an abort during it fails
    the batch's request instead of delivering it, and the queued request
    behind it; ``start()`` serves again."""
    _, tm = models
    started, release = threading.Event(), threading.Event()
    real = tm.generate

    def held_generate(*a, **kw):
        started.set()
        release.wait(60)
        return real(*a, **kw)

    eng = pt.ServingEngine(tm, max_batch_size=1, batch_window_s=0.0,
                           device="cpu")
    p = np.random.RandomState(6).randint(0, 128, (1, 8)).astype(np.int64)
    errors = [None, None]

    def run(i):
        try:
            eng.generate(p, max_new_tokens=3, timeout=300)
        except RuntimeError as e:
            errors[i] = e

    tm.generate = held_generate
    try:
        eng.start()
        a = threading.Thread(target=run, args=(0,))
        a.start()
        assert started.wait(60)
        b = _submit(eng, lambda: run(1))
        aborter = threading.Thread(target=eng.abort)
        aborter.start()
        deadline = time.monotonic() + 30
        while not eng._aborted and time.monotonic() < deadline:
            time.sleep(0.001)
        release.set()
        for t in (a, b, aborter):
            t.join(60)
            assert not t.is_alive()
    finally:
        release.set()
        del tm.generate
    assert all(e is not None and "aborted" in str(e) for e in errors), errors
    with eng:
        out = np.asarray(eng.generate(p, max_new_tokens=3, timeout=300))
    np.testing.assert_array_equal(
        out, real(torch.as_tensor(p), max_new_tokens=3, use_paged_cache=True,
                  page_size=16).numpy())


# ---------------------------------------------------------------------------
# the bounded program family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget, chunk", [(16, 16), (100, 48), (256, 5)])
def test_declared_buckets_and_families_match_jax(models, budget, chunk):
    jm, tm = models
    kw = dict(max_batch_size=4, max_len=64, token_budget=budget,
              prefill_chunk_tokens=chunk)
    for ragged in (True, False):
        jeng = JaxEngine(jm, enable_ragged=ragged, **kw)
        declared = jco.declared_families()
        teng = pt.ContinuousServingEngine(tm, device="cpu",
                                          enable_ragged=ragged, **kw)
        assert teng.declared_token_buckets() == \
            jeng.declared_token_buckets()
        assert teng.declared_chunk_buckets() == \
            jeng.declared_chunk_buckets()
        if ragged:
            assert declared["serving.ragged"]["buckets"]["tokens"] == \
                sorted(teng.declared_token_buckets())
        else:
            assert declared["serving.prefill_chunk"]["buckets"][
                "tokens"] == sorted(teng.declared_chunk_buckets())
            assert declared["serving.decode"]["buckets"]["tokens"] == \
                [teng.max_batch]
        # every width a tick pads to is declared
        for n in range(1, budget + 1):
            assert tserving._token_bucket(n, teng.token_budget) in \
                teng.declared_token_buckets()
        for n in range(1, chunk + 1):
            assert tserving._chunk_bucket(n, teng.chunk_tokens) in \
                teng.declared_chunk_buckets()


@pytest.mark.parametrize("scheduler", ["qblock", "token", "legacy"])
def test_warmup_leaves_streams_and_pages_unchanged(models, scheduler):
    """Warming every declared shape (before start, and again through
    run_on_loop on the live engine) changes no stream, no free page
    count and no length; it returns the reference's family names."""
    _, tm = models
    plain = _port(tm, scheduler)
    want = _drive(plain, _load_requests())
    eng = _port(tm, scheduler)
    fams = eng.warmup_programs()
    assert set(fams) == ({"serving.ragged"} if scheduler != "legacy" else
                         {"serving.prefill_chunk", "serving.decode"})
    assert all(s >= 0 for s in fams.values())
    cache = eng._adopt
    free0 = cache.free_page_count
    assert free0 == cache.num_pages - 1 and (cache.lens == 0).all()
    assert not eng.cuda_graphs       # the CPU runs every tick eagerly
    seen = {}

    def again(e):
        seen.update(fams=e.warmup_programs(), adopted=e._cache is cache,
                    free=e._cache.free_page_count)

    got = _drive(eng, _load_requests(), before=again)
    assert seen["adopted"] and seen["free"] == free0
    assert set(seen["fams"]) == set(fams)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert eng._cache.free_page_count == plain._cache.free_page_count
    assert _counters(eng) == _counters(plain)


def test_launches_count_now_or_record_for_a_graph(monkeypatch):
    """``_build.launch`` is the one place launch counters rise. Outside a
    CUDA graph capture it counts at once; under one it records into the
    open ``record_launches()`` record, which credits the counts once per
    replay; under a capture with no record open it raises before the
    kernel runs. Driven with a stand-in kernel library and a stand-in
    capture state (this machine has no card)."""
    from paddle_tpu_torch.ops import _build
    calls, capturing = [], [False]
    lib = type("Lib", (), {})()
    lib.ptt_fake = lambda *args: calls.append(args) or 0
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])

    def wrapper():
        pass
    wrapper.launches, by_m = 0, {}
    counters = ((wrapper, "launches"), (by_m, 8))
    dev = torch.device("cuda", 0)

    _build.launch("ptt_fake", dev, (1,), counters)
    assert (wrapper.launches, by_m, len(calls)) == (1, {8: 1}, 1)
    capturing[0] = True
    with pytest.raises(RuntimeError, match="outside record_launches"):
        _build.launch("ptt_fake", dev, (1,), counters)
    assert len(calls) == 1 and wrapper.launches == 1
    with _build.record_launches() as rec:
        with pytest.raises(RuntimeError, match="already open"):
            with _build.record_launches():
                pass
        for _ in range(3):
            _build.launch("ptt_fake", dev, (1,), counters)
    assert (wrapper.launches, by_m, len(calls)) == (1, {8: 1}, 4)
    rec.credit()                        # one replay
    assert (wrapper.launches, by_m) == (4, {8: 4})
    rec.credit()
    assert (wrapper.launches, by_m) == (7, {8: 7})
    capturing[0] = False
    lib.ptt_fake = lambda *args: 1      # a failed launch counts nothing
    lib.ptt_error_string = lambda rc: b"stand-in error"
    with pytest.raises(RuntimeError, match="stand-in error"):
        _build.launch("ptt_fake", dev, (1,), counters)
    assert (wrapper.launches, by_m) == (7, {8: 7})


def test_slot_cache_step_ends_in_end_step(models):
    """A slot cache's forward reads the buffers its ``begin_*`` staged and
    leaves the lengths alone; ``end_step`` advances them, so a replayed
    graph needs no Python of the forward. A forward wider than the armed
    step, or on another device than the buffers, raises."""
    from paddle_tpu_torch.models.generation import SlotPagedKVCache
    _, tm = models
    cache = SlotPagedKVCache(2, page_size=8, max_len=64)
    prompt = np.arange(1, 12, dtype=np.int64)
    cache.assign(0, prompt)
    cache.begin_ragged([(0, 0, 11)], num_tokens=16)
    flat = np.zeros(16, np.int64)
    flat[:11] = prompt
    with torch.no_grad():
        tm.forward(flat[None], cache=cache, position_ids=np.arange(16))
        assert list(cache.lens) == [0, 0]
        cache.end_step()
        assert list(cache.lens) == [11, 0]
        cache.begin_decode(np.asarray([True, False]))
        tm.forward(np.asarray([[5], [0]]), cache=cache,
                   position_ids=cache.lens[:, None])
        assert list(cache.lens) == [11, 0]
        cache.end_step()
        assert list(cache.lens) == [12, 0]
        cache.begin_ragged([(0, 0, 1)])
        with pytest.raises(ValueError, match="armed for 1 tokens got 2"):
            tm.forward(np.asarray([[5, 0]]), cache=cache,
                       position_ids=np.asarray([12, 0]))
    meta = SlotPagedKVCache(2, page_size=8, max_len=64, device="meta")
    meta.assign(0, prompt)
    with pytest.raises(ValueError, match="pass the model's device"):
        meta._mode = ("decode", np.asarray([True, False]))
        meta.attend(None, *(torch.zeros(2, 1, 2, 4) for _ in "qkv"))


# ---------------------------------------------------------------------------
# the q-block kernels' fixed grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra_slots", [0, 5])
@pytest.mark.parametrize("name", sorted(UNITS.LAYOUTS))
def test_padded_qblock_plan_gives_the_unpadded_bits(name, extra_slots):
    """A plan padded to the fixed grid (``U_max`` units, ``J_max`` jobs a
    block, padding jobs of slot -2, the live unit count on the device)
    gives kernel 6's plain version the unpadded plan's bits in fp32, and
    its live units are the unpadded plan's unit list."""
    c = UNITS._case(name)
    max_slots = c["tbl"].shape[0] + extra_slots
    plan = trpa.make_plan(c["T"], *c["desc"], c["tbl"], c["page"],
                          impl="qblock", q_block=c["q_block"],
                          max_slots=max_slots)
    u_max, j_max = trpa.qblock_caps(c["T"], c["q_block"], max_slots,
                                    c["tbl"].shape[1])
    h, h0 = plan.host, c["plan"].host
    nb = -(-c["T"] // c["q_block"])
    assert u_max == min(nb * min(c["q_block"], max_slots), nb + max_slots)
    assert h["units"].shape == (u_max, 4)
    assert h["job_page"].shape == h["job_slot"].shape == (nb, j_max)
    live = int(h["n_units"][0])
    assert live == len(h0["units"]) == int(h0["n_units"][0]) <= u_max
    np.testing.assert_array_equal(h["units"][:live], h0["units"])
    assert (h["units"][live:] == 0).all()
    J = h0["job_page"].shape[1]
    for key in ("job_page", "job_slot", "job_kv"):
        np.testing.assert_array_equal(h[key][:, :J], h0[key])
    assert (h["job_slot"][:, J:] == -2).all()
    UNITS.check_units(h["units"][:live], dict(c, plan=plan))
    q, kp, vp = (torch.from_numpy(c[k]) for k in ("q", "kp", "vp"))
    scale = 1.0 / math.sqrt(q.shape[-1])
    want = trpa.qblock_attention_plain(q, kp, vp, c["plan"], scale)
    got = trpa.qblock_attention_plain(q, kp, vp, plan, scale)
    assert torch.equal(got, want)
    assert torch.equal(UNITS.unit_walk(dict(c, plan=plan),
                                       h["units"][:live]),
                       UNITS.unit_walk(c))


@pytest.mark.parametrize("seed", range(6))
def test_fixed_grid_holds_every_tick_of_its_bucket(seed):
    """Random ticks of a bucket (decode spans first, then prefill spans,
    then padding; any slots, any contexts) never need more units than
    ``U_max`` nor more jobs a q-block than ``J_max``, and the padded plan
    keeps the plain version's bits."""
    rng = np.random.RandomState(seed)
    slots, pps, page, qb = 8, 4, 8, 8
    tbl = rng.permutation(np.arange(1, slots * pps + 1)).astype(
        np.int32).reshape(slots, pps)
    kp = torch.from_numpy(rng.randn(2, slots * pps + 1, page, 16)
                          .astype(np.float32))
    vp = torch.from_numpy(rng.randn(*kp.shape).astype(np.float32))
    for _ in range(20):
        T = int(rng.choice([1, 2, 4, 8, 16, 32, 64]))
        order = rng.permutation(slots)[:rng.randint(1, slots + 1)]
        spans, off = [], 0
        for s in order:
            n = 1 if rng.rand() < 0.5 else rng.randint(1, T + 1)
            n = min(n, T - off, pps * page)
            if n <= 0:
                break
            ctx = rng.randint(n, pps * page + 1)
            spans.append((int(s), off, n, ctx))
            off += n
        desc = tuple(np.asarray([x[i] for x in spans], np.int32)
                     for i in range(4))
        u_max, j_max = trpa.qblock_caps(T, qb, slots, pps)
        host = trpa.plan_arrays(T, *desc, tbl, page, q_block=qb)
        assert int(host["n_units"][0]) <= u_max
        assert (host["job_slot"] >= 0).sum(axis=1).max() <= j_max
        plan = trpa.make_plan(T, *desc, tbl, page, q_block=qb,
                              max_slots=slots)
        live = trpa.make_plan(T, *desc, tbl, page, q_block=qb)
        q = torch.from_numpy(rng.randn(T, 4, 16).astype(np.float32))
        assert torch.equal(trpa.qblock_attention_plain(q, kp, vp, plan, 0.25),
                           trpa.qblock_attention_plain(q, kp, vp, live, 0.25))


def test_fixed_grid_refuses_a_schedule_wider_than_its_jobs():
    c = UNITS._case("pure_decode")
    with pytest.raises(ValueError, match="fixed width"):
        trpa.qblock_schedule(c["T"], *c["desc"], c["tbl"], c["q_block"],
                             c["page"], num_jobs=2)


def test_padding_only_tick_plans_and_runs():
    """A tick of padding alone (the warm-up's) has a plan: every token
    reads slot 0 with context 1, as bucket padding does."""
    tbl = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    empty = [np.zeros(0, np.int32)] * 4
    for impl in trpa.IMPLS:
        plan = trpa.make_plan(8, *empty, tbl, 8, impl=impl, q_block=4,
                              max_slots=2)
        if impl == "token":
            assert plan.host["tok_slot"].tolist() == [0] * 8
            assert plan.host["tok_ctx"].tolist() == [1] * 8
        else:
            assert int(plan.host["n_units"][0]) == 2
        kp = torch.randn(2, 9, 8, 16)
        out = trpa.ragged_paged_attention(
            torch.randn(8, 4, 16), kp, kp.clone(), tbl, *empty, impl=impl,
            plan=plan)
        assert torch.isfinite(out).all()
