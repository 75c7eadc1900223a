"""The port's Mixtral (``paddle_tpu_torch/models/mixtral.py``) served
against the reference's (``paddle_tpu/models/mixtral.py``) on shared
weights, fp32, CPU: greedy streams of ``generate`` on the concat and the
paged caches, and of the continuous engine against the reference engine
(its ticks route their padding tokens too), each under the near-tie rule
(ROADMAP C29)."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousServingEngine as JaxEngine
from paddle_tpu.models import mixtral as jmix

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import mixtral as tmix
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)
from test_torch_serving import ENGINE_KW, _drive_in_order, _prompts
from torch_zoo_common import (  # noqa: F401
    arrays_of, assert_stream, jt, one_torch_thread)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    kw = dict(max_position_embeddings=128)
    jm = jmix.MixtralForCausalLM(jmix.mixtral_tiny(**kw))
    tm = tmix.MixtralForCausalLM(tmix.mixtral_tiny(**kw), device="cpu")
    pt.load_jax_state(tm, arrays_of(jm))
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int64)


def _ref_next_logits(jm, prompt_rows):
    def at(row, prefix):
        ids = np.concatenate([prompt_rows[row], prefix])[None]
        return np.asarray(jm(jt(ids))._data)[0, -1]
    return at


@pytest.mark.parametrize("paged", [False, True])
def test_generate_streams_match_reference(models, paged):
    jm, tm = models
    ids = _ids(2, 9, seed=5)
    kw = dict(use_paged_cache=True, page_size=4) if paged else {}
    want = np.asarray(jm.generate(jt(ids), max_new_tokens=4, **kw)._data)
    got = tm.generate(ids, max_new_tokens=4, **kw)
    assert_stream(got[:, 9:], want[:, 9:], _ref_next_logits(jm, ids),
                  f"generate paged={paged}")


def test_engine_streams_match_reference(models, monkeypatch):
    """The port's continuous engine serves Mixtral as the reference's
    does: every tick routes its padding tokens too, which take capacity
    in both."""
    jm, tm = models
    prompts = _prompts()
    monkeypatch.setenv("PADDLE_TPU_RAGGED_IMPL", "qblock")
    jeng = JaxEngine(jm, **ENGINE_KW)
    want = _drive_in_order(jeng, prompts, 4)
    teng = pt.ContinuousServingEngine(tm, device="cpu", **ENGINE_KW)
    got = _drive_in_order(teng, prompts, 4)
    for i, (g, w, p) in enumerate(zip(got, want, prompts)):
        assert_stream(g[:, p.shape[1]:], w[:, p.shape[1]:],
                      _ref_next_logits(jm, p), f"engine prompt {i}")
    assert teng.ragged_steps == jeng.ragged_steps > 0
    assert (teng.padded_tokens_total, teng.useful_tokens_total) == (
        jeng.padded_tokens_total, jeng.useful_tokens_total)
