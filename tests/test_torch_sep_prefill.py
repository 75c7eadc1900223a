"""The port's long-context (sep) serving against the JAX package's: the
cache's striped lifecycle (``assign_sep``, ``begin_sep_prefill``,
``begin_sep_decode``, stripes and the tail window, ``sep_view``) driven
alike on both caches (the reference's ``tests/test_sep_prefill.py:79-137``
at its 2e-5), the striped handoff, the validation errors, the engine's
greedy streams on a prompt larger than the page pool equal to the
reference engine's and to ``generate``, speculative decoding beside sep
rows equal to spec off, and the dtype trace under ``auto_cast`` O2."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.autograd.tape import no_grad
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models import generation as jgen

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.inference.speculative import DraftModelDrafter
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import flash_attention as tfa

from test_torch_amp_serving import _JaxTrace, _torch_records
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)
from test_torch_serving import _drive_in_order

#: the reference's tolerance, striped against dense attention
TOL = dict(rtol=2e-5, atol=2e-5)
#: the sep counters of a cache
SEP_COUNTERS = ("sep_stripes_stored", "sep_chunks", "sep_decode_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _xla_ring(monkeypatch):
    """The reference's blockwise attention on its XLA tier and its ragged
    attention on its XLA tier, as its tests may run them (its
    interpret-mode kernels take seconds a call on the CPU; the kernel
    tier is held in ``test_torch_ring_attention.py``)."""
    monkeypatch.setenv("PADDLE_SEP_RING_IMPL", "xla")
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "xla")


def _caches(max_batch=2, **kw):
    kw = dict(dict(page_size=4, max_len=64, num_pages=9,
                   allow_page_overcommit=True), **kw)
    return (jgen.SlotPagedKVCache(max_batch, host_pool=jgen.HostKVPool(0),
                                  **kw),
            tgen.SlotPagedKVCache(max_batch, **kw))


def _qkv(seed, total, h=4, hk=2, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, total, h, d)).astype(np.float32),
            rng.standard_normal((1, total, hk, d)).astype(np.float32),
            rng.standard_normal((1, total, hk, d)).astype(np.float32))


def _drive(cache, layer, qkv, plen, stripe, new, port, slot=0):
    """The reference test's ``_drive_sep``: chunked sep prefill, then one
    decode token at a time; the attention output of every real
    position."""
    q_all, k_all, v_all = qkv

    def attend(sl, pad=0):
        arrays = [np.pad(a[:, sl], ((0, 0), (0, pad), (0, 0), (0, 0)))
                  for a in (q_all, k_all, v_all)]
        if port:
            out = cache.attend(layer, *(torch.from_numpy(a) for a in arrays))
            cache.end_step()
            return out.numpy()
        out = cache.attend(layer, *(Tensor(jnp.asarray(a)) for a in arrays))
        cache.advance(arrays[0].shape[1])
        return np.asarray(out._data)

    assert cache.assign_sep(slot, plen, stripe) == -(-plen // stripe)
    outs, pos = [], 0
    while pos < plen:
        n = min(stripe, plen - pos)
        cache.begin_sep_prefill(slot, n_valid=n)
        outs.append(attend(slice(pos, pos + n), stripe - n)[:, :n])
        pos += n
    for t in range(new):
        cache.begin_sep_decode(slot)
        outs.append(attend(slice(plen + t, plen + t + 1)))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("prompt_len", [21, 24])
def test_sep_cache_matches_the_reference(prompt_len):
    """With and without a trailing partial chunk, the prompt larger than
    the pool's 8 usable pages: the port's outputs within 2e-5 of the
    reference cache's and of dense attention, the counters, the view,
    the lengths and the tail tables equal to the reference's."""
    stripe, new = 8, 5
    qkv = _qkv(1, prompt_len + new)
    jc, tc = _caches()
    want = _drive(jc, object(), qkv, prompt_len, stripe, new, port=False)
    got = _drive(tc, object(), qkv, prompt_len, stripe, new, port=True)
    np.testing.assert_allclose(got, want, **TOL)
    dense = tfa.mha_reference(*(torch.from_numpy(a).transpose(1, 2)
                                for a in qkv)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, dense, **TOL)
    for name in SEP_COUNTERS:
        assert getattr(tc, name) == getattr(jc, name)
    assert tc.sep_stripes_stored == prompt_len // stripe
    assert tc.sep_view(0) == jc.sep_view(0)
    assert tc.sep_view(0)["len"] == prompt_len and tc.sep_view(1) is None
    np.testing.assert_array_equal(tc.lens, jc.lens)
    np.testing.assert_array_equal(tc._tables, jc._tables)
    assert tc.used_page_count == jc.used_page_count
    assert tc.used_page_count <= -(-(prompt_len % stripe + new) // 4)
    tc.free(0)
    assert tc.sep_view(0) is None and tc.used_page_count == 0


def test_striped_handoff_continues_bit_exact():
    """``export_stripes`` then ``import_stripes`` into a second cache
    mid-decode: the stripes carry their homes on a ring of four, equal
    the reference's export, and the next token's attention is
    bit-identical on both caches."""
    stripe, plen, new = 8, 21, 5
    qkv = _qkv(2, plen + new + 1)
    jc, src = _caches()
    layer = object()
    _drive(jc, object(), qkv, plen, stripe, new, port=False)
    _drive(src, layer, qkv, plen, stripe, new, port=True)
    blob = src.export_stripes(0, sep_ways=4)
    jblob = jc.export_stripes(0, sep_ways=4)
    assert [st["home"] for st in blob["stripes"]] == [0, 1]
    for key in ("page_size", "stripe", "base", "len", "pos", "sep_ways",
                "native_dtype"):
        assert blob[key] == jblob[key]
    for ours, theirs in zip(blob["stripes"] + [{"layers": blob["tail"]}],
                            jblob["stripes"] + [{"layers": jblob["tail"]}]):
        for (k, v), (jk, jv) in zip(ours["layers"], theirs["layers"]):
            assert isinstance(k, np.ndarray)
            np.testing.assert_array_equal(k, np.asarray(jk))
            np.testing.assert_array_equal(v, np.asarray(jv))

    _, dst = _caches()
    # make dst's pools with a scratch chunk, then import
    dst.assign_sep(1, 4, stripe)
    dst.begin_sep_prefill(1, n_valid=4)
    dst.attend(layer, torch.zeros(1, stripe, 4, 8), torch.zeros(1, stripe, 2, 8),
               torch.zeros(1, stripe, 2, 8))
    dst.end_step()
    dst.free(1)
    assert dst.import_stripes(0, blob) == 2
    p = plen + new
    outs = []
    for cache in (src, dst):
        cache.begin_sep_decode(0)
        outs.append(cache.attend(layer, *(torch.from_numpy(a[:, p:p + 1])
                                          for a in qkv)).numpy())
        cache.end_step()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert src.sep_view(0) == dst.sep_view(0)


def test_sep_validation():
    _, cache = _caches()
    with pytest.raises(ValueError):           # stripe % page_size != 0
        cache.assign_sep(0, 20, 6)
    with pytest.raises(ValueError):           # prompt > max_len
        cache.assign_sep(0, 100, 8)
    with pytest.raises(RuntimeError):         # not sep-assigned
        cache.begin_sep_prefill(1)
    cache.assign_sep(0, 20, 8)
    cache.begin_sep_prefill(0, n_valid=8)
    with pytest.raises(ValueError):           # a chunk is one stripe
        cache.attend(object(), torch.zeros(1, 4, 4, 8),
                     torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8))
    qcache = tgen.SlotPagedKVCache(1, page_size=4, max_len=32, num_pages=9,
                                   kv_dtype="int8",
                                   allow_page_overcommit=True)
    with pytest.raises(ValueError):           # int8 pools are paged only
        qcache.assign_sep(0, 20, 8)
    with pytest.raises(ValueError):           # no overcommit without it
        tgen.SlotPagedKVCache(1, page_size=4, max_len=64, num_pages=9)
    with pytest.raises(ValueError):
        tgen.SlotPagedKVCache(1, page_size=4, max_len=64, num_pages=1,
                              allow_page_overcommit=True)


# -- the engines ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models(_no_reference_mesh):
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=2))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=2),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


#: three slots over a pool of 12 usable pages (48 tokens): half of it is
#: the sep threshold, so the 60-token prompt takes the sep path and the
#: short ones the ragged one
SEP_KW = dict(max_batch_size=3, page_size=4, max_len=96, num_pages=13,
              sep_prefill=True, sep_stripe_tokens=16)


def _load():
    """A 60-token prompt, larger than the pool, and two short ones."""
    rng = np.random.RandomState(7)
    long = rng.randint(0, 128, (1, 60)).astype(np.int64)
    short = rng.randint(0, 128, (1, 6)).astype(np.int64)
    return [long, short, short[:, :4]]


@pytest.fixture(scope="module")
def reference(models):
    """The reference engine's streams and sep counters on the load, its
    ragged and ring attention on their XLA tiers (``_xla_ring``, here for
    the module)."""
    jm, _ = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_SEP_RING_IMPL", "xla")
        mp.setenv("PADDLE_TPU_RAGGED_IMPL", "xla")
        jeng = JaxEngine(jm, **SEP_KW)
        want = _drive_in_order(jeng, _load(), 4)
    return want, jeng


def test_engine_long_context_matches_the_reference(models, reference):
    """The 60-token prompt is sep-served beside two short ones that take
    the paged path: every greedy stream equal to the reference engine's
    (the long one also to the port's ``generate``), and the sep counters
    equal the reference's."""
    _, tm = models
    want, jeng = reference
    prompts = _load()
    teng = pt.ContinuousServingEngine(tm, device="cpu", **SEP_KW)
    got = _drive_in_order(teng, prompts, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], tm.generate(
        torch.from_numpy(prompts[0]), max_new_tokens=4).numpy())
    assert teng.sep_requests == jeng.sep_requests == 1
    for name in SEP_COUNTERS:
        assert getattr(teng, name) == getattr(jeng._cache, name)
    assert teng.sep_chunks == -(-60 // 16) and teng.sep_stripes_stored == 3
    assert ("sep_chunk", 0, 12, True) in teng.events


def test_spec_beside_sep_rows_matches_the_reference(models, reference):
    """Speculative decoding on the engine serving the sep row beside the
    ragged rows: sep rows are never drafted, the ragged rows' verify spans
    roll back as usual, and every greedy stream equals the reference
    engine's without speculation (so spec off's), with the self-drafter
    (drafts accepted) and with a drafter that is always wrong (drafts
    rolled back)."""
    _, tm = models
    want, _ = reference

    class Wrong:
        def propose(self, history, k):
            return [(int(history[-1]) + 1) % 128] * int(k)

    for drafter in (DraftModelDrafter(tm), Wrong()):
        eng = pt.ContinuousServingEngine(tm, device="cpu", **SEP_KW,
                                         spec_decode=True, spec_k=2,
                                         drafter=drafter)
        for g, w in zip(_drive_in_order(eng, _load(), 4), want):
            np.testing.assert_array_equal(g, w)
        assert eng.spec_drafted_tokens > 0 and eng.sep_requests == 1
        # the sep row's 3 decode tokens ran as sep steps, undrafted
        assert eng.sep_decode_steps == 3


def test_engine_validation_and_warmup(models):
    _, tm = models
    kw = dict(device="cpu", page_size=16)
    eng = pt.ContinuousServingEngine(tm, **kw, sep_prefill=True,
                                     sep_stripe_tokens=32,
                                     sep_threshold_tokens=77)
    assert eng.sep_prefill_enabled and eng.sep_stripe == 32
    assert eng.sep_threshold == 77
    assert pt.ContinuousServingEngine(
        tm, **kw, sep_prefill=True).sep_stripe == 512
    with pytest.raises(ValueError):
        pt.ContinuousServingEngine(tm, **kw, sep_prefill=True,
                                   sep_stripe_tokens=30)
    with pytest.raises(ValueError):
        pt.ContinuousServingEngine(tm, **kw, sep_prefill=True,
                                   enable_ragged=False)
    with pytest.raises(ValueError):
        pt.ContinuousServingEngine(tm, **kw, sep_prefill=True,
                                   kv_dtype="int8")
    assert not pt.ContinuousServingEngine(tm, **kw).sep_prefill_enabled
    small = pt.ContinuousServingEngine(
        tm, device="cpu", max_batch_size=1, page_size=4, max_len=40,
        num_pages=4, sep_prefill=True, sep_stripe_tokens=8)
    out = small.warmup_programs()
    assert set(out) == {"serving.ragged", "serving.sep_prefill",
                        "serving.sep_decode"}
    assert small._adopt.used_page_count == 0


def test_o2_dtype_trace_equals_the_reference(models, monkeypatch):
    """A sep chunk and a sep decode step of both models under
    ``auto_cast(level="O2", dtype="bfloat16")``: the same op records,
    and the op ``"sep_ring_attention"`` casts q alone from fp32 to bf16,
    once a layer a forward."""
    jm, tm = models
    jc, tc = _caches(max_batch=1, max_len=40)
    jtrace = _JaxTrace(monkeypatch)
    prompt = np.random.RandomState(3).randint(0, 128, 12)
    kw = dict(level="O2", dtype="bfloat16")
    with debugging.collect_operator_stats() as stats, \
            jamp.auto_cast(**kw), amp.auto_cast(**kw):
        for c in (jc, tc):
            c.assign_sep(0, 12, 8)
        for start in (0, 8):
            n = min(8, 12 - start)
            chunk = np.zeros(8, np.int64)
            chunk[:n] = prompt[start:start + n]
            pos = np.minimum(np.arange(start, start + 8), start + n - 1)
            for c in (jc, tc):
                c.begin_sep_prefill(0, n)
            with no_grad():
                jm(Tensor(jnp.asarray(chunk[None])), cache=jc,
                   position_ids=pos)
            with torch.no_grad():
                tm(chunk[None], cache=tc, position_ids=pos)
            tc.end_step()
        for c in (jc, tc):
            c.begin_sep_decode(0)
        cur, pos = np.asarray([[5]], np.int64), np.asarray([[12]])
        with no_grad():
            jm(Tensor(jnp.asarray(cur)), cache=jc, position_ids=pos)
        with torch.no_grad():
            tm(cur, cache=tc, position_ids=pos)
        tc.end_step()
    ttrace = _torch_records(stats)
    assert ttrace == jtrace.records
    sep = [r for r in ttrace if r[0] == "sep_ring_attention"]
    assert sep == [("sep_ring_attention", ("float32",), ("bfloat16",))] * 6
