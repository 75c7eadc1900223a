"""Serving under ``amp.auto_cast`` against the reference (ROADMAP C29).

Both packages keep the AMP state global, so a caller's ``auto_cast``
holds for every op of ``generate`` and for the engines' serve threads.
The reference casts the cached attention op's one tensor argument, q
(``paddle_tpu/models/generation.py:354``, ``:1400``, ``:1435``), and the
weight-only int8 Linear's (``quantization/__init__.py:310``); its pools
stay in k's dtype, fp32 after the rope (C25). Two-layer ``llama_tiny``
on both packages, weights through ``load_jax_state``, the reference run
as its own tests run it (interpret mode, ``no_grad``):

* the dtype trace of the cached paths (``PagedKVCache`` prefill and
  decode, a ``SlotPagedKVCache`` ragged tick, the legacy chunk and
  decode step; and int8 pages under int8 weights), op by op, in every
  mode of ``test_torch_amp.MODES``;
* greedy streams equal to the reference's under O2 bf16 and O1 fp16 for
  ``generate``, the static engine and the continuous engine (q-block,
  per-token and legacy schedulers, native and int8 pools, int8 weights
  once), and every cached forward's logits within two units of the AMP
  dtype's roundoff at the reference's largest magnitude;
* the continuous engine's tick programs keyed by the AMP state: one
  bucket run outside and then inside ``auto_cast`` holds two programs.

Planted faults (the attention sites' cast dropped, programs keyed by
shape alone) are caught by the same checks.
"""
import contextlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu import quantization as jquant
from paddle_tpu.autograd import tape as jtape
from paddle_tpu.autograd.tape import no_grad
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.inference import ServingEngine as JaxStatic
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models import generation as jgen

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch import quantization as tquant
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.models import generation as tgen
from test_torch_amp import MODES, _name
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)


def _load(name):
    """A sibling test module, loaded by path (``tests/`` is no package)."""
    path = Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SERVING = _load("test_torch_serving.py")
#: the C25 file's engine load, helpers and settings (one model, two slots,
#: three prompts sharing a prefix, three new tokens each)
C25 = _load("test_torch_c25.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAYERS = 2
NEW = C25.NEW
#: the reference's cached attention ops; each casts q alone
CACHED_OPS = ("paged_attention", "ragged_paged_attention")


def _models(mode, weights_int8=False):
    """A fresh reference and port model on shared weights, in ``mode``:
    cast or decorated as the mode says, after ``quantize_linears`` when
    ``weights_int8`` (an engine built with ``weight_dtype="int8"`` finds
    them quantised). Returns (jm, tm, auto_cast arguments or None)."""
    cast, deco, kw = MODES[mode]
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=LAYERS,
                        max_position_embeddings=64))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=LAYERS,
                                           max_position_embeddings=64),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    if cast:
        jm.to(dtype=cast)
        tm.to(getattr(torch, cast))
    if deco:
        jamp.decorate(jm, level="O2", dtype=deco)
        amp.decorate(tm, level="O2", dtype=deco)
    if weights_int8:
        jm.eval()
        tm.eval()
        assert jquant.quantize_linears(jm) == tquant.quantize_linears(tm)
    return jm, tm, kw


@contextlib.contextmanager
def _both_under(kw):
    """Both packages' AMP state set by ``kw`` (none when ``kw`` is None)."""
    if kw is None:
        yield
        return
    with jamp.auto_cast(**kw), amp.auto_cast(**kw):
        yield


def _ids(seed, *shape):
    return np.random.RandomState(seed).randint(0, 128, shape).astype(
        np.int64)


# -- the dtype trace of the cached paths -------------------------------------

class _JaxTrace:
    """Every op the reference's tape hands the AMP policy (but the policy's
    own ``"cast"`` ops): its name, input dtypes and cast dtypes. With AMP
    off the tape's fast path skips the policy for flat arguments; the
    probe turns it off (the general path computes the same), so every op
    is seen in every mode."""

    def __init__(self, monkeypatch):
        self.records, inner = [], jtape._amp_cast_inputs

        def record(name, leaves):
            out = inner(name, leaves)
            if name != "cast":
                self.records.append((
                    name,
                    tuple(_name(a.dtype) for a in leaves
                          if isinstance(a, Tensor)),
                    tuple(_name(a.dtype) for a in out
                          if isinstance(a, Tensor))))
            return out
        monkeypatch.setattr(jtape, "_amp_cast_inputs", record)
        monkeypatch.setattr(jtape, "_amp_active", lambda: True)


def _torch_records(stats):
    return [(op, tuple(_name(d) for d in ins), tuple(_name(d) for d in cs))
            for op, ins, cs in stats.records]


def _run_paged(jm, tm):
    """Prefill 12 tokens of two rows, then one decode step."""
    jc = jgen.PagedKVCache(page_size=16, max_len=32)
    tc = tgen.PagedKVCache(page_size=16, max_len=32)
    ids = _ids(1, 2, 12)
    for chunk in (ids, ids[:, -1:]):
        with no_grad():
            jm(Tensor(jnp.asarray(chunk)), cache=jc)
        with torch.no_grad():
            tm(chunk, cache=tc)
    return 1


def _slot_caches(kv_dtype="native"):
    jc = jgen.SlotPagedKVCache(2, page_size=16, max_len=64, num_pages=9,
                               kv_dtype=kv_dtype)
    tc = tgen.SlotPagedKVCache(2, page_size=16, max_len=64, num_pages=9,
                               kv_dtype=kv_dtype, device="cpu")
    return jc, tc


def _ragged_step(jm, tm, jc, tc, spans, flat, pos):
    jc.begin_ragged(spans)
    tc.begin_ragged(spans, num_tokens=flat.shape[0])
    with no_grad():
        jm(Tensor(jnp.asarray(flat[None])), cache=jc, position_ids=pos)
    with torch.no_grad():
        tm(flat[None], cache=tc, position_ids=pos)
    tc.end_step()


def _run_ragged(jm, tm, kv_dtype="native"):
    """A mixed tick (prompts of 10 and 7 tokens, padded to 32), then a
    pure-decode tick of both slots."""
    jc, tc = _slot_caches(kv_dtype)
    prompts = [_ids(2, 10), _ids(3, 7)]
    for slot, p in enumerate(prompts):
        jc.assign(slot, p)
        tc.assign(slot, p)
    flat = np.zeros(32, np.int64)
    flat[:10], flat[10:17] = prompts
    pos = np.zeros(32, np.int64)
    pos[:10], pos[10:17] = np.arange(10), np.arange(7)
    _ragged_step(jm, tm, jc, tc, [(0, 0, 10), (1, 10, 7)], flat, pos)
    _ragged_step(jm, tm, jc, tc, [(0, 0, 1), (1, 1, 1)],
                 np.asarray([5, 9], np.int64), np.asarray([10, 7]))
    return 2


def _run_legacy(jm, tm):
    """A prefill chunk a slot (10 and 7 tokens, padded to 16 and 8, so
    the second reads nothing back), then one ``[2, 1]`` decode step."""
    jc, tc = _slot_caches()
    for slot, (n, padded) in enumerate(((10, 16), (7, 8))):
        p = _ids(4 + slot, n)
        jc.assign(slot, p)
        tc.assign(slot, p)
        chunk = np.zeros(padded, np.int64)
        chunk[:n] = p
        pos = np.minimum(np.arange(padded), n - 1)
        jc.begin_prefill(slot, n)
        tc.begin_prefill(slot, n)
        with no_grad():
            jm(Tensor(jnp.asarray(chunk[None])), cache=jc, position_ids=pos)
        with torch.no_grad():
            tm(chunk[None], cache=tc, position_ids=pos)
        tc.end_step()
    mask = np.ones(2, bool)
    jc.begin_decode(mask)
    tc.begin_decode(mask)
    cur, pos = np.asarray([[3], [8]], np.int64), tc.lens[:, None].copy()
    with no_grad():
        jm(Tensor(jnp.asarray(cur)), cache=jc, position_ids=pos)
    with torch.no_grad():
        tm(cur, cache=tc, position_ids=pos)
    tc.end_step()
    return 1


#: path -> (driver, cached attention op, weights int8): the driver returns
#: how many forwards ran the cached attention op
PATHS = {
    "paged": (_run_paged, "paged_attention", False),
    "ragged": (_run_ragged, "ragged_paged_attention", False),
    "legacy": (_run_legacy, "paged_attention", False),
    "ragged-int8": (lambda jm, tm: _run_ragged(jm, tm, "int8"),
                    "ragged_paged_attention", True),
}


def _cast_dtype(mode, op):
    """What the mode's policy makes of an fp32 q at ``op``: the AMP dtype
    under O2 (neither op is black), fp32 under O1 (neither is listed) and
    without AMP."""
    kw = MODES[mode][2]
    if kw and kw["level"] == "O2" and op not in kw.get(
            "custom_black_list", ()):
        return kw["dtype"]
    return "float32"


def _traces(mode, path, monkeypatch):
    drive, op, weights_int8 = PATHS[path]
    jm, tm, kw = _models(mode, weights_int8)
    jtrace = _JaxTrace(monkeypatch)
    with debugging.collect_operator_stats() as stats, _both_under(kw):
        steps = drive(jm, tm)
    return jtrace.records, _torch_records(stats), op, steps


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cached_dtype_trace_equals_the_reference(mode, path, monkeypatch):
    """Record for record: the same op names, input dtypes and cast
    dtypes, the cached attention ops included (one a layer a step that
    reads the pages), each casting q from fp32 as the reference does."""
    jtrace, ttrace, op, steps = _traces(mode, path, monkeypatch)
    assert ttrace == jtrace
    cached = [r for r in jtrace if r[0] in CACHED_OPS]
    assert cached == [(op, ("float32",), (_cast_dtype(mode, op),))] * (
        LAYERS * steps)
    if PATHS[path][2]:
        assert sum(r[0] == "int8_linear" for r in jtrace) > 0


def test_dropped_attention_cast_fails_the_trace(monkeypatch):
    """Planted fault: the port's cached attention sites without their
    AMP cast (the port before C29 was closed)."""
    real = amp.amp_cast_inputs

    def skip(op, args):
        return list(args) if op in CACHED_OPS else real(op, args)
    monkeypatch.setattr(amp, "amp_cast_inputs", skip)
    jtrace, ttrace, _, _ = _traces("O2-bf16", "paged", monkeypatch)
    missing = [r for r in jtrace if r not in ttrace]
    assert [r[0] for r in missing] == ["paged_attention"] * LAYERS


# -- streams and logits under O2 bf16 and O1 fp16 ---------------------------

ENGINE_MODES = ("O1-fp16", "O2-bf16")
#: one unit of the AMP dtype's roundoff
ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def assert_logits(got, want, mode, msg):
    """Same dtype; within two roundoffs of the AMP dtype at the
    reference's largest magnitude (one 16-bit ulp of a logit apart in
    either package's last rounding, and the rounded inputs before it)."""
    got, want = np.asarray(got), np.asarray(want)
    assert _name(got.dtype) == _name(want.dtype), (msg, got.dtype,
                                                   want.dtype)
    assert got.shape == want.shape, msg
    got, want = got.astype(np.float32), want.astype(np.float32)
    err = float(np.abs(got - want).max())
    bound = 2 * ROUNDOFF[MODES[mode][2]["dtype"]] * float(np.abs(want).max())
    assert err <= bound, (msg, err, bound)


@pytest.mark.parametrize("cache", ["concat", "paged"])
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_cached_logits_within_two_roundoffs(mode, cache):
    jm, tm, kw = _models(mode)
    if cache == "paged":
        jc = jgen.PagedKVCache(page_size=16, max_len=32)
        tc = tgen.PagedKVCache(page_size=16, max_len=32)
    else:
        jc, tc = jgen.KVCache(), tgen.KVCache()
    ids = _ids(6, 2, 12)
    with _both_under(kw):
        for step, chunk in enumerate((ids, ids[:, -1:], _ids(7, 2, 1))):
            with no_grad():
                want = np.asarray(jm(Tensor(jnp.asarray(chunk)),
                                     cache=jc)._data)
            with torch.no_grad():
                got = tm(chunk, cache=tc)
            assert got.dtype == getattr(torch, kw["dtype"])
            assert_logits(got.float().numpy().astype(want.dtype), want, mode,
                          f"{cache} step {step}")


@pytest.mark.parametrize("cache", ["concat", "paged"])
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_generate_streams_equal_the_reference(mode, cache):
    jm, tm, kw = _models(mode)
    ids = _ids(8, 2, 20)
    gen_kw = dict(max_new_tokens=4)
    if cache == "paged":
        gen_kw.update(use_paged_cache=True, page_size=16)
    with _both_under(kw):
        want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                      **gen_kw).numpy())
        got = tm.generate(ids, **gen_kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_static_engine_streams_equal_the_reference(mode):
    jm, tm, kw = _models(mode)
    prompts = [_ids(9, 1, 20), _ids(10, 1, 20)]
    eng_kw = dict(max_batch_size=2, batch_window_s=30.0)
    with _both_under(kw):
        jeng = JaxStatic(jm, **eng_kw)
        want = SERVING._drive_in_order(jeng, prompts, NEW)
        teng = pt.ServingEngine(tm, device="cpu", **eng_kw)
        got = SERVING._drive_in_order(teng, prompts, NEW)
    assert teng.batches_run == jeng.batches_run == 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


ENGINE_KW, SCHEDULERS = C25.ENGINE_KW, C25.SCHEDULERS
_Logits, _run, _pool_dtypes = C25._Logits, C25._run, C25._pool_dtypes


def _jax_numpy(out):
    return np.asarray(out._data)


def _torch_numpy(out):
    """fp32 values of the port's logits, tagged with the reference's
    numpy dtype of the same name (bf16 has no numpy type of torch's)."""
    a = out.detach().float().numpy()
    if out.dtype == torch.bfloat16:
        return a.astype(jnp.bfloat16)
    return a.astype(str(out.dtype).replace("torch.", ""))


def _pool_dtypes(cache):
    return {str(a.dtype).replace("torch.", "")
            for kv in cache._pools.values() for a in kv}


def _engines(mode, scheduler, kv, monkeypatch, weights_int8=False):
    jm, tm, kw = _models(mode)
    opts = SCHEDULERS[scheduler]
    eng_kw = dict(ENGINE_KW, kv_dtype=kv,
                  weight_dtype="int8" if weights_int8 else None)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL",
                       opts.get("ragged_impl", "qblock"))
    with _both_under(kw):
        jeng = JaxEngine(jm, enable_ragged=opts.get("enable_ragged", True),
                         **eng_kw)
        want, jlogits = _run(jeng, jm, _jax_numpy)
        teng = pt.ContinuousServingEngine(tm, device="cpu", **eng_kw, **opts)
        got, tlogits = _run(teng, tm, _torch_numpy)
    return (jeng, want, jlogits), (teng, got, tlogits)


def _check_engines(mode, ref, port, kv, msg):
    jeng, want, jlogits = ref
    teng, got, tlogits = port
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pools = "int8" if kv == "int8" else "float32"
    assert _pool_dtypes(teng._cache) == _pool_dtypes(jeng._cache) == {pools}
    assert len(tlogits) == len(jlogits) > 0
    for i, (g, w) in enumerate(zip(tlogits, jlogits)):
        assert_logits(g, w, mode, f"{msg} forward {i}")


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_engine_streams_pools_and_logits(mode, scheduler, kv, monkeypatch):
    """The continuous engine under the caller's ``auto_cast``: the serve
    threads of both packages follow it. Streams equal, pools in k's
    dtype (fp32, or int8 codes), every forward's logits within the
    bound, in the AMP dtype."""
    ref, port = _engines(mode, scheduler, kv, monkeypatch)
    _check_engines(mode, ref, port, kv, f"{scheduler} {kv}")
    assert {_name(a.dtype) for a in port[2]} == {MODES[mode][2]["dtype"]}


@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_int8_weights_engine_streams_and_logits(mode, monkeypatch):
    """Fully int8 (int8 pages, ``weight_dtype="int8"``): the int8 Linear
    is the reference's op ``"int8_linear"``, whose scales O2 rounds to
    the AMP dtype."""
    ref, port = _engines(mode, "qblock", "int8", monkeypatch,
                         weights_int8=True)
    assert port[0].quantized_linears == ref[0].quantized_linears > 0
    _check_engines(mode, ref, port, "int8", "int8 weights")


# -- tick programs keyed by the AMP state -------------------------------------

def _warm_twice(eng):
    """Warm every declared program outside and then inside O2 bf16;
    returns the program keys after each."""
    eng.warmup_programs()
    outside = set(eng._programs)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        eng.warmup_programs()
    return outside, set(eng._programs)


@pytest.mark.parametrize("scheduler", ["qblock", "legacy"])
def test_a_tick_under_another_amp_state_gets_its_own_program(scheduler):
    """Each tick shape run outside and then inside ``auto_cast`` holds two
    programs, one a state, with the same shapes; on the card each is a
    CUDA graph of its own."""
    _, tm, _ = _models("O2-bf16")
    eng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW,
                                     **SCHEDULERS[scheduler])
    outside, both = _warm_twice(eng)
    inside = both - outside
    assert len(outside) == len(inside) > 0
    assert {k[0] for k in outside} == {k[0] for k in inside}
    assert {k[1] for k in outside} == {amp.state_key()} == {(False,)}
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert {k[1] for k in inside} == {amp.state_key()}


def test_programs_keyed_by_shape_alone_would_be_shared(monkeypatch):
    """Planted fault: a key without the AMP state (the port before this
    change) warms no program of its own inside ``auto_cast``, so on the
    card a graph captured outside would replay inside."""
    _, tm, _ = _models("O2-bf16")
    monkeypatch.setattr(amp, "state_key", lambda: (False,))
    eng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW)
    outside, both = _warm_twice(eng)
    assert both == outside


def _serve_both_states(eng, model, numpy_of, kw):
    """One serving session: a request outside ``auto_cast``, then the
    same request inside. Returns ``{state: (stream, logits dtypes)}``."""
    out, prompt = {}, C25._engine_prompts()[2]
    with eng:
        for state in ("outside", "inside"):
            probe = _Logits(model, numpy_of)
            try:
                with _both_under(kw if state == "inside" else None):
                    stream = eng.generate(prompt, max_new_tokens=NEW,
                                          timeout=300)
            finally:
                probe.close()
            out[state] = (np.asarray(stream),
                          {_name(a.dtype) for a in probe.seen})
    return out


def test_one_engine_serves_both_states_as_the_reference():
    """One engine serves the same request outside and then inside
    ``auto_cast``: fp32 logits outside (a bf16 model without AMP, C25),
    bf16 inside, the reference's streams in each state, and two programs
    for the tick shape both states ran."""
    jm, tm, kw = _models("O2-bf16")
    want = _serve_both_states(JaxEngine(jm, **ENGINE_KW), jm, _jax_numpy,
                              kw)
    teng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW)
    got = _serve_both_states(teng, tm, _torch_numpy, kw)
    for state, dtype in (("outside", "float32"), ("inside", "bfloat16")):
        np.testing.assert_array_equal(got[state][0], want[state][0])
        assert got[state][1] == want[state][1] == {dtype}
    # the decode bucket ran in both states (the second request's prefill
    # hit the first's prefix, so its prefill tick took another bucket)
    states = {}
    for shape, state in teng._programs:
        states.setdefault(shape, set()).add(state)
    with amp.auto_cast(**kw):
        inside = amp.state_key()
    assert states[("ragged", 1)] == {(False,), inside}
