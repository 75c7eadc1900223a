"""ROADMAP C25 on the CPU: a bf16 or fp16 model's cached paths compute as
the reference's do. The rope makes q and k fp32 (C24), the caches keep k
as it is (the concat store) or allocate their pools in k's dtype (fp32
pages; int8 codes with fp32 scales under ``kv_dtype="int8"``), so the
cached attention, ``o_proj`` and everything after it run in fp32 and the
logits are fp32, in both packages.

A two-layer ``llama_tiny`` in bf16 and in fp16 (``.to()``, weights
through ``load_jax_state``) against the reference on the same weights:
the concat and paged caches' forwards (prefill, then a decode step) and
``generate`` over both, the continuous engine's q-block, per-token and
legacy schedulers with native and int8 KV pages (every forward's logits
beside the reference engine's, tick for tick), and a speculative verify
span. Logits within the cache-free path's C24 bound (one bf16 roundoff,
2^-8, of the logits' max; the same bound in fp16) and greedy streams
equal."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.autograd.tape import no_grad
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models import generation as jgen

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import generation as tgen
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


def _load(name):
    """A sibling test module, loaded by path (``tests/`` is no package)."""
    path = Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FINISH = _load("test_torch_serving_finish.py")

LAYERS = 2
NEW = 3
ENGINE_KW = dict(max_batch_size=2, max_len=64, page_size=16,
                 prefill_chunk_tokens=16, token_budget=32)
SCHEDULERS = {"qblock": dict(ragged_impl="qblock"),
              "token": dict(ragged_impl="token"),
              "legacy": dict(enable_ragged=False)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(_no_reference_mesh):  # noqa: F811
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["bfloat16", "float16"])
def models(request):
    """(dtype name, JAX model, port model) on shared weights, both cast to
    the 16-bit dtype after loading."""
    paddle.seed(0)
    jm = JaxLlama(jtiny(num_hidden_layers=LAYERS,
                        max_position_embeddings=128))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(num_hidden_layers=LAYERS,
                                           max_position_embeddings=128),
                             device="cpu")
    pt.load_jax_state(tm, arrays)
    jm.to(dtype=request.param)
    tm.to(getattr(torch, request.param))
    return request.param, jm, tm


def assert_logits(got, want, msg):
    """fp32 in both, within one 2^-8 roundoff of the reference's max."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32, (msg, got.dtype,
                                                   want.dtype)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= 2.0 ** -8 * np.abs(want).max(), (msg, err)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 128, (2, n)).astype(
        np.int64)


@pytest.mark.parametrize("cache", ["concat", "paged"])
def test_cached_forward_pools_and_logits_follow_k(models, cache):
    """Prefill then one decode step through each cache: fp32 logits in
    both packages within the bound; the paged pools are fp32 in both; the
    concat store keeps k and v in the reference's dtypes, layer by layer
    (fp32 k; v in the parameters' dtype at layer 0, fp32 after it)."""
    name, jm, tm = models
    ids = _prompt(12, 1)
    if cache == "paged":
        jc = jgen.PagedKVCache(page_size=16, max_len=32)
        tc = tgen.PagedKVCache(page_size=16, max_len=32)
    else:
        jc, tc = jgen.KVCache(), tgen.KVCache()
    for step, chunk in enumerate((ids, ids[:, -1:])):
        with no_grad():
            want = jm(Tensor(jnp.asarray(chunk)), cache=jc)._data
        with torch.no_grad():
            got = tm(chunk, cache=tc)
        assert_logits(got.numpy(), np.asarray(want), f"{cache} step {step}")
    if cache == "paged":
        jd = {str(a.dtype) for kv in jc._pools.values() for a in kv}
        td = {str(a.dtype) for kv in tc._pools.values() for a in kv}
        assert jd == {"float32"} and td == {"torch.float32"}
    else:
        jd = [(str(k.dtype), str(v.dtype)) for k, v in jc._store.values()]
        td = [(str(k.dtype)[6:], str(v.dtype)[6:])
              for k, v in tc._store.values()]
        assert td == jd == [("float32", name)] + [("float32", "float32")] * (
            LAYERS - 1)


@pytest.mark.parametrize("cache", ["concat", "paged"])
def test_generate_streams_equal_the_reference(models, cache):
    _, jm, tm = models
    ids = _prompt(20, 2)
    kw = dict(max_new_tokens=4)
    if cache == "paged":
        kw.update(use_paged_cache=True, page_size=16)
    want = np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())
    got = tm.generate(ids, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


class _Logits:
    """Every forward's logits of an engine's model, in call order."""

    def __init__(self, model, numpy_of):
        self.model, self.seen = model, []
        real = model.forward

        def forward(*a, **kw):
            out = real(*a, **kw)
            self.seen.append(numpy_of(out))
            return out
        model.forward = forward

    def close(self):
        del self.model.forward
        self.model = None


def _engine_prompts():
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, 128, 16)
    return [np.concatenate([prefix, rng.randint(0, 128, n)])[None]
            .astype(np.int64) for n in (5, 9)] + [
        rng.randint(0, 128, (1, 21)).astype(np.int64)]


def _run(eng, model, numpy_of):
    probe = _Logits(model, numpy_of)
    try:
        outs = FINISH._drive(eng, [(p, dict(max_new_tokens=NEW))
                                   for p in _engine_prompts()])
    finally:
        probe.close()
    return outs, probe.seen


def _pool_dtypes(cache):
    return {str(a.dtype).replace("torch.", "")
            for kv in cache._pools.values() for a in kv}


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_engine_pools_logits_and_streams(models, scheduler, kv,
                                         monkeypatch):
    _, jm, tm = models
    opts = SCHEDULERS[scheduler]
    kw = dict(ENGINE_KW, kv_dtype=kv)
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL",
                       opts.get("ragged_impl", "qblock"))
    jeng = JaxEngine(jm, enable_ragged=opts.get("enable_ragged", True),
                     **kw)
    want, jlogits = _run(jeng, jm, lambda o: np.asarray(o._data))
    teng = pt.ContinuousServingEngine(tm, device="cpu", **kw, **opts)
    got, tlogits = _run(teng, tm, lambda o: o.detach().numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pools = "int8" if kv == "int8" else "float32"
    assert _pool_dtypes(teng._cache) == _pool_dtypes(jeng._cache) == {pools}
    assert len(tlogits) == len(jlogits) > 0
    for i, (g, w) in enumerate(zip(tlogits, jlogits)):
        assert_logits(g, w, f"{scheduler} {kv} forward {i}")


def test_speculative_verify_spans_follow_k(models):
    """Self-speculation: verify spans on fp32 pools, fp32 logits, greedy
    streams equal the reference engine's without speculation."""
    _, jm, tm = models
    jeng = JaxEngine(jm, **ENGINE_KW)
    want, _ = _run(jeng, jm, lambda o: np.asarray(o._data))
    teng = pt.ContinuousServingEngine(tm, device="cpu", spec_decode=True,
                                      spec_k=2, draft_model=tm, **ENGINE_KW)
    got, tlogits = _run(teng, tm, lambda o: o.detach().numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert teng.spec_drafted_tokens > 0 and teng.spec_accepted_tokens > 0
    assert _pool_dtypes(teng._cache) == {"float32"}
    assert {a.dtype for a in tlogits} == {np.dtype(np.float32)}
