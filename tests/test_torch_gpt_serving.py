"""The port's GPT (``paddle_tpu_torch/models/gpt.py``) served against the
reference's (``paddle_tpu/models/gpt.py``) on shared weights, fp32, CPU:
greedy streams of ``generate`` on the concat cache, the paged cache,
without a cache and in beam search, and of the continuous engine (both
ragged kernels' plain versions) against the reference engine, each
under the near-tie rule (ROADMAP C29)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import gpt as tgpt
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)
from test_torch_serving import ENGINE_KW, _drive_in_order, _prompts
from torch_zoo_common import (  # noqa: F401
    arrays_of, assert_stream, jt, npy, one_torch_thread)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    kw = dict(max_position_embeddings=128)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**kw))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**kw), device="cpu")
    pt.load_jax_state(tm, arrays_of(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int64)


def _ref_next_logits(jm):
    """The reference's cache-free next-token logits after ``prefix``."""
    def fn(row_prompt):
        def at(row, prefix):
            ids = np.concatenate([row_prompt[row], prefix])[None]
            return np.asarray(jm(jt(ids))._data)[0, -1]
        return at
    return fn


@pytest.mark.parametrize("path", ["dense", "paged", "uncached", "beam"])
def test_generate_streams_match_reference(models, path):
    jm, tm = models
    ids = _ids(2, 9, seed=4)
    kw = {"dense": {}, "paged": dict(use_paged_cache=True, page_size=4),
          "uncached": {}, "beam": dict(num_beams=3)}[path]
    if path == "uncached":
        jm.supports_cache = tm.supports_cache = False
    try:
        want = np.asarray(jm.generate(jt(ids), max_new_tokens=4, **kw)._data)
        got = tm.generate(ids, max_new_tokens=4, **kw)
    finally:
        for m in (jm, tm):
            vars(m).pop("supports_cache", None)
    assert got.dtype == torch.int64 and got.shape == (2, 13)
    if path == "beam":
        np.testing.assert_array_equal(npy(got), want)
    else:
        assert_stream(got[:, 9:], want[:, 9:],
                      _ref_next_logits(jm)(ids), f"generate {path}")


def test_engine_streams_match_reference(models, monkeypatch):
    """The port's continuous engine serves GPT (kernels 6 and 8's plain
    versions here) as the reference's engine does: the same greedy
    streams, prefix hits and ticks."""
    jm, tm = models
    prompts = _prompts()
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    jeng = JaxEngine(jm, **ENGINE_KW)
    want = _drive_in_order(jeng, prompts, 5)
    for impl in ("qblock", "token"):
        teng = pt.ContinuousServingEngine(tm, device="cpu", ragged_impl=impl,
                                          **ENGINE_KW)
        got = _drive_in_order(teng, prompts, 5)
        for i, (g, w, p) in enumerate(zip(got, want, prompts)):
            assert g.shape == (1, p.shape[1] + 5)
            assert_stream(g[:, p.shape[1]:], w[:, p.shape[1]:],
                          _ref_next_logits(jm)(p),
                          f"engine {impl}, prompt {i}")
        assert teng.ragged_steps == jeng.ragged_steps > 0
        assert teng.prefix_hits == jeng._cache.prefix_hits > 0


def test_serving_kernels_get_a_dense_q(models, monkeypatch):
    """GPT's q is a strided slice of its fused projection; the caches hand
    the paged and ragged kernels (which take dense tensors on the card) a
    dense copy: on generate's paged cache and on the engine's ragged and
    legacy ticks."""
    from paddle_tpu_torch.models import generation as gen
    _, tm = models
    seen = []

    def recording(fn):
        def call(q, *args, **kw):
            seen.append((fn.__name__, q.is_contiguous()))
            return fn(q, *args, **kw)
        return call
    for name in ("paged_attention", "ragged_paged_attention"):
        monkeypatch.setattr(gen, name, recording(getattr(gen, name)))
    tm.generate(_ids(2, 9, seed=5), max_new_tokens=3, use_paged_cache=True,
                page_size=4)
    for ragged in (True, False):
        eng = pt.ContinuousServingEngine(tm, device="cpu",
                                         enable_ragged=ragged, **ENGINE_KW)
        _drive_in_order(eng, _prompts()[:2], 3)
    assert {name for name, _ in seen} == {"paged_attention",
                                          "ragged_paged_attention"}
    assert all(dense for _, dense in seen), seen
