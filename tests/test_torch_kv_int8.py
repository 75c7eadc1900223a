"""The port's int8 KV pages against the JAX package: the row codec bit
for bit, the plain versions of kernels B5, B7 and B9 against the
interpret-mode Pallas quant kernels, ``SlotPagedKVCache(kv_dtype="int8")``
against the JAX cache, and the fully-int8 engine's greedy streams (int8
pages and int8 weights) on all three schedulers against the JAX
engine's, token for token."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.core import Tensor
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny
from paddle_tpu.models import generation as jgen
from paddle_tpu.ops.pallas import paged_attention as jpa

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

from test_torch_serving import _drive_in_order
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)

# the package exports a function of the module's name
jrpa = importlib.import_module("paddle_tpu.ops.pallas.ragged_paged_attention")

#: plain versions against the interpret-mode kernels: the same fp32
#: recurrence, dots summed in another order
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(_no_reference_mesh):  # noqa: F811
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      and x.dtype == torch.bfloat16 else x)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_codec_bit_equal_to_jax(dtype):
    """Codes and scales equal bit for bit, the input cast to fp32 first
    whatever its dtype; rows include zeros (the 1e-8 floor) and exact
    ``.5`` ties (round half to even)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 64) * 3.0).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = np.arange(64) - 31.5        # scale 31.5/127: ties at .5
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jgen.quantize_kv_rows(jx)
    tq, ts = tgen.quantize_kv_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tgen.dequantize_kv_rows(tq, ts, tx.dtype)
    assert back.dtype == tx.dtype
    np.testing.assert_array_equal(
        _np(back), np.asarray(jgen.dequantize_kv_rows(jq, js, jx.dtype),
                              np.float32))
    err = np.abs(tgen.dequantize_kv_rows(tq, ts).numpy() - _np(tx))
    assert (err <= ts.numpy()[..., None] / 2 + 1e-7).all()


@pytest.mark.parametrize("args", [
    (8, 128, 16, "int8", "float32", 32), (8, 128, 16, "native", "bfloat16",
                                          32),
    (2, 16, 16, "native", "float32", 1), (2, 16, 8, "int8", "float32", 2)])
def test_kv_page_nbytes_matches_jax(args):
    assert tgen.kv_page_nbytes(*args) == jgen.kv_page_nbytes(*args)
    ratio = (tgen.kv_page_nbytes(8, 128, 16, "native", "bfloat16")
             / tgen.kv_page_nbytes(8, 128, 16, "int8"))
    assert abs(ratio - 2 * 128 / 132) < 1e-12          # 1.94x at d = 128


# ---------------------------------------------------------------------------
# plain versions of B5, B7 and B9 against the interpret-mode Pallas kernels
# (the layouts of tests/test_kv_int8.py)
# ---------------------------------------------------------------------------

def _quant_pool(kv=2, npages=10, page=8, d=32, seed=0):
    rs = np.random.RandomState(seed)
    kq, ks = jgen.quantize_kv_rows(rs.randn(kv, npages, page, d))
    vq, vs = jgen.quantize_kv_rows(rs.randn(kv, npages, page, d))
    tbl = rs.randint(1, npages, (3, 4)).astype(np.int32)
    return [np.asarray(a) for a in (kq, ks, vq, vs)] + [tbl]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_paged_decode_q8_plain_matches_interpret_kernel():
    kq, ks, vq, vs, tbl = _quant_pool()
    q = np.random.RandomState(1).randn(3, 4, 32).astype(np.float32)
    lens = np.asarray([20, 7, 30], np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), kq, vq, jnp.asarray(tbl), jnp.asarray(lens),
        k_scales=ks, v_scales=vs, interpret=True))
    tq, tkq, tks, tvq, tvs = _torch(q, kq, ks, vq, vs)
    got = tpa.paged_attention(tq, tkq, tvq, tbl, lens, k_scales=tks,
                              v_scales=tvs)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the B5 wrapper itself, and nothing counted on the CPU
    direct = tpa.paged_attention_q8(tq, tkq, tvq, tks, tvs, tbl, lens,
                                    32 ** -0.5)
    np.testing.assert_array_equal(direct.numpy(), got.numpy())
    assert tpa.paged_attention_q8.launches == 0
    assert tpa.paged_attention.launches == 0


#: decode span + speculative verify span (q_len 4) + prefill span
RAGGED_LAYOUT = [(0, 0, 1, 20), (1, 1, 4, 12), (2, 5, 3, 3)]


@pytest.mark.parametrize("impl", trpa.IMPLS)
def test_ragged_q8_plain_matches_interpret_kernel(impl, monkeypatch):
    kq, ks, vq, vs, tbl = _quant_pool(seed=2)
    q = np.random.RandomState(3).randn(8, 4, 32).astype(np.float32)
    desc = [np.asarray([x[i] for x in RAGGED_LAYOUT], np.int32)
            for i in range(4)]
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", impl)
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(q), kq, vq, tbl, *desc, k_scales=ks, v_scales=vs,
        interpret=True))
    tq, tkq, tks, tvq, tvs = _torch(q, kq, ks, vq, vs)
    got = trpa.ragged_paged_attention(tq, tkq, tvq, tbl, *desc, impl=impl,
                                      k_scales=tks, v_scales=tvs)
    rows = np.concatenate([np.arange(a, a + n) for _, a, n, _ in
                           RAGGED_LAYOUT])
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)
    # B7 against B9's plain version, and both against the dense oracle
    # on the dequantised pages (the reference's own 2e-5)
    other = trpa.ragged_paged_attention(
        tq, tkq, tvq, tbl, *desc, impl="token" if impl == "qblock"
        else "qblock", k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(other.numpy()[rows], got.numpy()[rows], **TOL)
    ref = trpa.ragged_paged_attention_reference(
        tq, tgen.dequantize_kv_rows(tkq, tks),
        tgen.dequantize_kv_rows(tvq, tvs), tbl, *desc)
    np.testing.assert_allclose(got.numpy()[rows], ref.numpy()[rows],
                               rtol=2e-5, atol=2e-5)
    counted = (trpa.qblock_attention_q8, trpa.token_attention_q8,
               trpa.qblock_attention, trpa.token_attention)
    assert all(fn.launches == 0 for fn in counted)
    with pytest.raises(ValueError, match="both"):
        trpa.ragged_paged_attention(tq, tkq, tvq, tbl, *desc, impl=impl,
                                    k_scales=tks)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class _Layer:                            # both caches key pools by id(layer)
    pass


def _kv(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_cache_int8_prefill_then_decode_matches_jax():
    """One prefill chunk then one decode step with one inactive row,
    mirroring ``tests/test_kv_int8.py:120``: the outputs within 1e-5 of
    the JAX cache's, pages and scales bit-equal after each scatter,
    ``page_nbytes`` equal."""
    steps = [("prefill", _kv(7, (1, 12, 4, 32)), _kv(5, (1, 12, 2, 32)),
              _kv(6, (1, 12, 2, 32))),
             ("decode", _kv(8, (2, 1, 4, 32)), _kv(9, (2, 1, 2, 32)),
              _kv(10, (2, 1, 2, 32)))]
    jc = jgen.SlotPagedKVCache(2, page_size=8, max_len=64, kv_dtype="int8")
    tc = tgen.SlotPagedKVCache(2, page_size=8, max_len=64, kv_dtype="int8")
    assert tc.kv_quant and tc.kv_dtype == "int8"
    jl, tl = _Layer(), _Layer()
    for c in (jc, tc):
        c.assign(0, np.arange(12))
    for mode, q, k, v in steps:
        for c in (jc, tc):
            if mode == "prefill":
                c.begin_prefill(0, 12)
            else:
                c.begin_decode(np.asarray([True, False]))
        want = np.asarray(jc.attend(jl, *(Tensor(jnp.asarray(a))
                                          for a in (q, k, v)))._data)
        got = tc.attend(tl, *_torch(q, k, v))
        for c in (jc, tc):
            c.advance(q.shape[1])
        rows = slice(None) if mode == "prefill" else slice(0, 1)
        np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)
        for j_arr, t_arr in zip(jc._pools[id(jl)] + jc._scales[id(jl)],
                                tc._pools[id(tl)] + tc._scales[id(tl)]):
            np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))
    assert tc._pools[id(tl)][0].dtype == torch.int8
    assert tc.page_nbytes == jc.page_nbytes == jgen.kv_page_nbytes(
        2, 32, 8, "int8")


def test_cow_copies_scales_like_jax():
    """Copy-on-write of an int8 page copies its scale rows with its codes,
    as the reference's ``_make_writable`` does: after a prefill whose full
    block is registered in the prefix index, making that block writable
    moves the slot to a new page holding the same codes and scales, and
    both caches' pools and scales stay bit-equal."""
    q, k, v = (_kv(s, (1, 12, h, 32)) for s, h in ((11, 4), (12, 2),
                                                    (13, 2)))
    jc = jgen.SlotPagedKVCache(2, page_size=8, max_len=64, kv_dtype="int8")
    tc = tgen.SlotPagedKVCache(2, page_size=8, max_len=64, kv_dtype="int8")
    jl, tl = _Layer(), _Layer()
    jc.assign(0, np.arange(12))
    jc.begin_prefill(0, 12)
    jc.attend(jl, *(Tensor(jnp.asarray(a)) for a in (q, k, v)))
    tc.assign(0, np.arange(12))
    tc.begin_prefill(0, 12)
    tc.attend(tl, *_torch(q, k, v))
    for c in (jc, tc):
        c.advance(12)
        assert c.commit_prefix(0) == 1
        old = int(c._tables[0, 0])
        c._make_writable(0, 0)
        assert c.cow_copies == 1 and int(c._tables[0, 0]) != old
    new = int(tc._tables[0, 0])
    assert new == int(jc._tables[0, 0])
    for arr in tc._pools[id(tl)] + tc._scales[id(tl)]:
        np.testing.assert_array_equal(arr[:, new].numpy(),
                                      arr[:, old].numpy())
    for j_arr, t_arr in zip(jc._pools[id(jl)] + jc._scales[id(jl)],
                            tc._pools[id(tl)] + tc._scales[id(tl)]):
        np.testing.assert_array_equal(t_arr.numpy(), np.asarray(j_arr))


def test_cache_rejects_bad_kv_dtype_and_reads_auto_as_native():
    with pytest.raises(ValueError):
        tgen.SlotPagedKVCache(2, page_size=8, max_len=64, kv_dtype="fp8")
    for value in (None, "auto", "NATIVE"):
        c = tgen.SlotPagedKVCache(2, page_size=8, max_len=64,
                                  kv_dtype=value)
        assert c.kv_dtype == "native" and not c.kv_quant


# ---------------------------------------------------------------------------
# the fully-int8 engine: int8 pages and int8 weights
# ---------------------------------------------------------------------------

#: hidden 128 over 2 heads: head_dim 64, the smallest the flash route
#: takes, so the legacy scheduler's read-back of a >= 128-token chunk
#: reaches it. One layer: the JAX engine runs every Linear through an
#: interpret-mode Pallas call (~0.35 s each on the CPU), so its ticks
#: cost seconds.
WIDE = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
            num_hidden_layers=1, max_position_embeddings=512)


@pytest.fixture(scope="module")
def models():
    """A JAX and a port model on shared weights. The first int8 engine
    on each quantises its Linears in place; later ones find none left."""
    paddle.seed(0)
    jm = JaxLlama(jtiny(**WIDE))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(**WIDE), device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


def _prompts():
    """Two prompts sharing a 32-token prefix around a 130-token one (a
    128-token chunk, the flash route under the legacy scheduler, then 2
    more that read the chunk back); with two slots the second sharer
    waits for one, by which time the first has committed the prefix."""
    rng = np.random.RandomState(16)
    prefix = rng.randint(0, 128, 32)
    return [np.concatenate([prefix, rng.randint(0, 128, 6)])[None],
            rng.randint(0, 128, (1, 130)),
            np.concatenate([prefix, rng.randint(0, 128, 4)])[None]]


ENGINE_KW = dict(max_batch_size=2, max_len=160, page_size=16,
                 prefill_chunk_tokens=128, token_budget=256,
                 kv_dtype="int8", weight_dtype="int8")

SCHEDULERS = {"qblock": dict(ragged_impl="qblock"),
              "token": dict(ragged_impl="token"),
              "legacy": dict(enable_ragged=False)}


@pytest.mark.parametrize("scheduler", sorted(SCHEDULERS))
def test_int8_engine_streams_bit_identical_to_jax(models, scheduler,
                                                  monkeypatch):
    jm, tm = models
    prompts = [p.astype(np.int64) for p in _prompts()]
    opts = SCHEDULERS[scheduler]
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL",
                       opts.get("ragged_impl", "qblock"))
    jeng = JaxEngine(jm, **ENGINE_KW,
                     enable_ragged=opts.get("enable_ragged", True))
    want = _drive_in_order(jeng, prompts, 2)
    teng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW, **opts)
    assert teng.quantized_linears == jeng.quantized_linears
    got = _drive_in_order(teng, prompts, 2)
    for w, g, p in zip(want, got, prompts):
        assert g.shape == (1, p.shape[1] + 2)
        np.testing.assert_array_equal(g, w)
    assert teng._cache.kv_quant and jeng._cache.kv_quant
    assert teng.prefix_hits == jeng._cache.prefix_hits > 0
    assert teng._cache.page_nbytes == jeng._cache.page_nbytes
    assert teng._cache.free_page_count == jeng._cache.free_page_count
    if scheduler == "legacy":
        assert (teng.prefill_chunks, teng.decode_steps) == (
            jeng.prefill_chunks, jeng.decode_steps)
        assert teng.prefill_chunk_buckets[128] >= 1     # the flash route
    else:
        assert teng.ragged_steps == jeng.ragged_steps > 0


def test_int8_prefix_hits_match_unshared_run(models):
    """Mirroring ``tests/test_kv_int8.py:361``: a run whose second prompt
    maps the first's prefix pages, codes and scales, gives exactly the
    streams of a run without the prefix cache (quantisation is
    deterministic, so int8 against int8 is exact)."""
    _, tm = models
    rng = np.random.RandomState(17)
    shared = rng.randint(0, 128, 32)
    prompts = [np.concatenate([shared, rng.randint(0, 128, 4)])[None]
               .astype(np.int64) for _ in range(2)]
    kw = dict(ENGINE_KW, max_batch_size=1)
    outs = []
    for prefix_cache in (False, True):
        eng = pt.ContinuousServingEngine(tm, device="cpu",
                                         enable_prefix_cache=prefix_cache,
                                         **kw)
        outs.append(_drive_in_order(eng, prompts, 4))
        assert (eng.prefix_hits > 0) == prefix_cache
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_engine_rejects_bad_dtypes(models):
    _, tm = models
    with pytest.raises(ValueError):
        pt.ContinuousServingEngine(tm, device="cpu", kv_dtype="fp8")
    with pytest.raises(ValueError):
        pt.ContinuousServingEngine(tm, device="cpu", weight_dtype="int4")
