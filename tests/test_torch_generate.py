"""The port's ``generate`` and the engines built on it against the JAX
package on shared weights, token for token.

The model is small but wide enough per head (``head_dim`` 64) and the
prompts long enough (>= 128 tokens) that attention reaches the flash
route (``seq_q >= 128``, ``head_dim % 64 == 0``) and, under the paged
caches, the paged decode route. Greedy streams must be bit-identical to
the JAX package's; seeded sampling need only repeat within the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.inference import ServingEngine as JaxStatic
from paddle_tpu.models import LlamaForCausalLM as JaxLlama, llama_tiny as jtiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa

from test_torch_serving import _drive_in_order
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread(_no_reference_mesh):  # noqa: F811
    """Tiny shapes gain nothing from intra-op threads; one keeps this
    file from crowding the suite's other workers off the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: hidden 128 over 2 heads: head_dim 64, the smallest the flash route takes
WIDE = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
            num_hidden_layers=2, max_position_embeddings=512)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jtiny(**WIDE))
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = pt.LlamaForCausalLM(pt.llama_tiny(**WIDE), device="cpu")
    pt.load_jax_state(tm, arrays)
    return jm, tm


def _ids(rows, n, seed):
    return np.random.RandomState(seed).randint(0, 128, (rows, n)).astype(
        np.int64)


def _jax_generate(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


class _Counts:
    """Launches of the two kernels' plain routes during a block."""

    def __init__(self, monkeypatch):
        self.flash = self.paged = 0
        real_fa, real_pa = tfa.flash_attention_plain, tpa.paged_decode_plain

        def fa(*a, **kw):
            self.flash += 1
            return real_fa(*a, **kw)

        def pa(*a, **kw):
            self.paged += 1
            return real_pa(*a, **kw)

        monkeypatch.setattr(tfa, "flash_attention_plain", fa)
        monkeypatch.setattr(tpa, "paged_decode_plain", pa)


@pytest.mark.parametrize("cache", ["concat", "paged"])
def test_greedy_generate_matches_jax(models, cache, monkeypatch):
    jm, tm = models
    ids = _ids(2, 140, 1)
    kw = dict(max_new_tokens=4)
    if cache == "paged":
        kw.update(use_paged_cache=True, page_size=16)
    want = _jax_generate(jm, ids, **kw)
    counts = _Counts(monkeypatch)
    got = tm.generate(ids, **kw)
    assert got.dtype == torch.int64 and got.shape == (2, 144)
    np.testing.assert_array_equal(got.numpy(), want)
    # one flash prefill per layer; the paged cache decodes through the
    # paged kernel's route, the concat cache through the einsum
    assert counts.flash == 2
    assert counts.paged == (2 * 3 if cache == "paged" else 0)


def test_beam_search_matches_jax(models):
    jm, tm = models
    ids = _ids(2, 130, 2)
    want = _jax_generate(jm, ids, max_new_tokens=3, num_beams=2)
    got = tm.generate(ids, max_new_tokens=3, num_beams=2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_and_max_length_match_jax(models):
    """Rows continue with eos once they emit it; ``max_length`` sets the
    total length."""
    jm, tm = models
    ids = _ids(2, 128, 3)
    free = tm.generate(ids, max_new_tokens=4).numpy()
    eos = int(free[0, 129])             # row 0's second new token
    want = _jax_generate(jm, ids, max_length=132, eos_token_id=eos)
    got = tm.generate(ids, max_length=132, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 129:] == eos).all()


def test_seeded_sampling_repeats_and_top_k_one_is_greedy(models):
    _, tm = models
    ids = _ids(2, 128, 4)
    kw = dict(max_new_tokens=4, do_sample=True, temperature=0.8, top_k=20,
              top_p=0.9)
    a = tm.generate(ids, seed=5, **kw)
    b = tm.generate(ids, seed=5, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    draws = {tuple(tm.generate(ids, seed=s, **kw)[:, 128:].flatten()
                   .tolist()) for s in range(6)}
    assert len(draws) > 1
    greedy = tm.generate(ids, max_new_tokens=4)
    one = tm.generate(ids, max_new_tokens=4, do_sample=True, top_k=1,
                      seed=9)
    np.testing.assert_array_equal(one.numpy(), greedy.numpy())


def _legacy_prompts():
    """A 300-token prompt (chunks of 128, 128 after a prefix, and 44 in a
    bucket of 64), a short one, and two sharing a 64-token prefix; the
    second sharer waits for a free slot, by which time the first has
    committed the prefix."""
    rng = np.random.RandomState(6)
    prefix = rng.randint(0, 128, 64)
    return [np.concatenate([prefix, rng.randint(0, 128, 80)])[None],
            rng.randint(0, 128, (1, 300)), rng.randint(0, 128, (1, 20)),
            np.concatenate([prefix, rng.randint(0, 128, 10)])[None]]


LEGACY_KW = dict(max_batch_size=3, max_len=320, page_size=16,
                 prefill_chunk_tokens=128, enable_ragged=False)


def test_legacy_engine_matches_jax(models, monkeypatch):
    jm, tm = models
    prompts = [p.astype(np.int64) for p in _legacy_prompts()]
    jeng = JaxEngine(jm, **LEGACY_KW)
    want = _drive_in_order(jeng, prompts, 3)
    counts = _Counts(monkeypatch)
    teng = pt.ContinuousServingEngine(tm, device="cpu", **LEGACY_KW)
    got = _drive_in_order(teng, prompts, 3)
    for w, g, p in zip(want, got, prompts):
        assert g.shape == (1, p.shape[1] + 3)
        np.testing.assert_array_equal(g, w)
    assert teng.prefix_hits == jeng._cache.prefix_hits > 0
    assert teng._cache.free_page_count == jeng._cache.free_page_count
    assert teng._cache.used_page_count == jeng._cache.used_page_count
    assert (teng.prefill_chunks, teng.decode_steps) == (
        jeng.prefill_chunks, jeng.decode_steps)
    assert (teng.padded_tokens_total, teng.useful_tokens_total) == (
        jeng.padded_tokens_total, jeng.useful_tokens_total)
    assert teng.ragged_steps == 0
    # every chunk padded to >= 128 tokens takes the flash route, every
    # decode step the paged one
    big = sum(n for size, n in teng.prefill_chunk_buckets.items()
              if size >= 128)
    assert big >= 3
    assert counts.flash == 2 * big
    assert counts.paged == 2 * teng.decode_steps


def test_legacy_and_ragged_engines_and_generate_agree(models):
    """The two schedulers and plain ``generate`` give the same greedy
    streams in the port alone."""
    _, tm = models
    prompts = [p.astype(np.int64) for p in _legacy_prompts()[:3]]
    legacy = _drive_in_order(pt.ContinuousServingEngine(
        tm, device="cpu", **LEGACY_KW), prompts, 2)
    ragged = _drive_in_order(pt.ContinuousServingEngine(
        tm, device="cpu", **dict(LEGACY_KW, enable_ragged=True)), prompts, 2)
    for a, b, p in zip(legacy, ragged, prompts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, tm.generate(p, max_new_tokens=2).numpy())


def test_static_engine_matches_jax_and_trims_eos(models):
    """Two requests of one shape run as one batch. With an eos that ends
    the first request's row early, its output stops there while its
    batch-mate runs on; both match the JAX engine."""
    jm, tm = models
    prompts = [_ids(1, 130, 7), _ids(1, 130, 8)]
    free = tm.generate(np.concatenate(prompts), max_new_tokens=4,
                       use_paged_cache=True).numpy()
    eos = int(free[0, 131])            # request 0's second new token
    assert eos not in free[1, 130:].tolist()
    # the group closes when full, long before the window ends
    kw = dict(max_batch_size=2, batch_window_s=30.0)
    jeng = JaxStatic(jm, **kw)
    want = _drive_in_order(jeng, prompts, 4, eos_token_id=eos)
    teng = pt.ServingEngine(tm, device="cpu", **kw)
    got = _drive_in_order(teng, prompts, 4, eos_token_id=eos)
    assert teng.batches_run == jeng.batches_run == 1
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (1, 132) and got[0][0, -1] == eos
    np.testing.assert_array_equal(got[1], free[1:])


def test_static_engine_refuses_when_stopped(models):
    _, tm = models
    eng = pt.ServingEngine(tm, device="cpu")
    with pytest.raises(RuntimeError):
        eng.generate(_ids(1, 8, 0), max_new_tokens=2)
    with eng:
        out = eng.generate(_ids(1, 8, 0), max_new_tokens=2, timeout=120)
    assert out.shape == (1, 10) and out.dtype == torch.int64
