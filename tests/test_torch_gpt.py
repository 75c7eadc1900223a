"""The port's GPT (``paddle_tpu_torch/models/gpt.py``) against the
reference's (``paddle_tpu/models/gpt.py``) on shared weights, fp32, CPU:
logits, loss and gradients; the AMP dtype trace op by op; a bf16 GPT's
KV pools in the model's dtype (it has no rope); the caches'
``attend(training=, dropout_p=)``; the flash route at head_dim 128,
group 1; weight carry-over and ``sharding_rules``. Its serving paths are
in ``tests/test_torch_gpt_serving.py``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.autograd.tape import no_grad as jno_grad
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import generation as jgen

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.functional import sdpa_route
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28)
from torch_zoo_common import (  # noqa: F401
    arrays_of, auto_cast, close, close_grads, dtype_name, jax_amp_trace, jt,
    npy, one_torch_thread, torch_amp_trace)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


def _pair(seed=0, **kw):
    kw.setdefault("max_position_embeddings", 128)
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**kw))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**kw), device="cpu")
    pt.load_jax_state(tm, arrays_of(jm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    jm, tm = _pair()
    jm.eval()
    tm.eval()
    return jm, tm


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 128, (b, s)).astype(
        np.int64)


def test_forward_and_loss_match_reference(models):
    jm, tm = models
    ids = _ids(2, 11)
    labels = _ids(2, 11, seed=1)
    close(tm(ids), jm(jt(ids)), "logits")
    jloss, _ = jm(jt(ids), labels=jt(labels))
    tloss, _ = tm(ids, labels=labels)
    close(tloss, jloss, "loss")


def test_training_grads_match_reference():
    """Train mode with both dropouts at 0: SDPA's causal route in both."""
    jm, tm = _pair(seed=1, **NO_DROPOUT)
    ids, labels = _ids(2, 10, seed=2), _ids(2, 10, seed=3)
    jloss, _ = jm(jt(ids), labels=jt(labels))
    tloss, _ = tm(ids, labels=labels)
    close(tloss, jloss, "training loss")
    jloss.backward()
    tloss.backward()
    close_grads(tm, jm, "GPT step")


# -- AMP ----------------------------------------------------------------------

MODES = {"O1-bf16": (None, dict(level="O1", dtype="bfloat16")),
         "O2-bf16": ("bfloat16", dict(level="O2", dtype="bfloat16")),
         "bf16-no-amp": (None, None)}


def _jax_trace(jm, mode, ids, monkeypatch):
    deco, kw = MODES[mode]
    if mode == "bf16-no-amp":
        jm.to(dtype="bfloat16")
    if deco:
        jamp.decorate(jm, level="O2", dtype=deco)

    def run():
        with auto_cast(jamp, kw):
            return jm(jt(ids), labels=jt(ids))[0]
    loss, trace = jax_amp_trace(run, monkeypatch)
    return trace, float(np.asarray(loss._data, np.float32))


def _torch_trace(tm, mode, ids):
    deco, kw = MODES[mode]
    if mode == "bf16-no-amp":
        tm.to(torch.bfloat16)
    if deco:
        amp.decorate(tm, level="O2", dtype=deco)

    def run():
        with auto_cast(amp, kw):
            return tm(ids, labels=ids)[0]
    loss, trace = torch_amp_trace(run)
    return trace, float(loss.detach())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_amp_dtype_trace_matches_reference(mode, monkeypatch):
    """Op by op, in training mode (dropout ops included), the same names,
    input dtypes and cast dtypes; both losses finite."""
    jm, tm = _pair(seed=2)
    ids = _ids(2, 8, seed=5)
    jtrace, jloss = _jax_trace(jm, mode, ids, monkeypatch)
    ttrace, tloss = _torch_trace(tm, mode, ids)
    assert any(op == "dropout" for op, *_ in jtrace)
    assert ttrace == jtrace
    assert np.isfinite(tloss) and np.isfinite(jloss)


@pytest.mark.parametrize("amp_kw", [None, dict(level="O2",
                                               dtype="bfloat16")])
def test_bf16_model_serves_on_pages_of_its_dtype(amp_kw):
    """No rope: k keeps the model's dtype, so a bf16 GPT's pools are
    bf16 in both packages, under O2 too; the logits' dtype is the
    reference's."""
    paddle.seed(3)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
    tm = pt.load_jax_state(tgpt.GPTForCausalLM(tgpt.gpt_tiny(),
                                               device="cpu"), arrays_of(jm))
    jm.to(dtype="bfloat16")
    tm.to(torch.bfloat16)
    jm.eval()
    tm.eval()
    ids = _ids(2, 6, seed=6)
    dtypes = []
    for lib, model, cache_cls, x in (
            ("jax", jm, jgen.PagedKVCache, jt(ids)),
            ("torch", tm, tgen.PagedKVCache, torch.from_numpy(ids))):
        cache = cache_cls(page_size=4, max_len=16)
        ctx = auto_cast(jamp if lib == "jax" else amp, amp_kw)
        # no gradients: the reference's Pallas decode has no JVP
        with ctx, (jno_grad() if lib == "jax" else torch.no_grad()):
            prefill = model(x, cache=cache)
            step = model(x[:, :1], cache=cache)
        dtypes.append(({dtype_name(a.dtype) for kv in cache._pools.values()
                        for a in kv}, dtype_name(prefill.dtype),
                       dtype_name(step.dtype)))
    assert dtypes[0] == dtypes[1]
    assert dtypes[1][0] == {"bfloat16"}


# -- the caches' attend -------------------------------------------------

class _Layer:
    """An attention layer's identity: the caches key their stores by it."""


def _qkv(seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 3, 2, 8).astype(np.float32) for _ in range(3)]


def test_concat_cache_attend_takes_training_and_dropout():
    """``KVCache.attend(..., training=, dropout_p=)`` passes both to SDPA:
    dropout inactive outside training, the reference's values; active in
    training, the output changes as the reference's does."""
    q, k, v = _qkv()
    lay = _Layer()
    for training, p in ((False, 0.0), (True, 0.0), (False, 0.5)):
        want = jgen.KVCache().attend(lay, jt(q), jt(k), jt(v),
                                     training=training, dropout_p=p)
        got = tgen.KVCache().attend(lay, *map(torch.from_numpy, (q, k, v)),
                                    training=training, dropout_p=p)
        close(got, want, f"KVCache.attend training={training} p={p}")
    plain = tgen.KVCache().attend(lay, *map(torch.from_numpy, (q, k, v)))
    dropped = tgen.KVCache().attend(lay, *map(torch.from_numpy, (q, k, v)),
                                    training=True, dropout_p=0.5)
    jdropped = jgen.KVCache().attend(lay, jt(q), jt(k), jt(v), training=True,
                                     dropout_p=0.5)
    assert not torch.allclose(dropped, plain)
    assert not np.allclose(npy(jdropped), npy(plain))


def test_paged_caches_refuse_dropout_in_training():
    """The serving caches raise ``ValueError`` on attention dropout in
    training, as the reference's ``PagedKVCache`` does; without it, or
    outside training, they attend."""
    q, k, v = _qkv()
    lay = _Layer()
    with pytest.raises(ValueError):
        jgen.PagedKVCache(page_size=4, max_len=8).attend(
            lay, jt(q), jt(k), jt(v), training=True, dropout_p=0.1)
    with pytest.raises(ValueError):
        tgen.PagedKVCache(page_size=4, max_len=8).attend(
            lay, *map(torch.from_numpy, (q, k, v)), training=True,
            dropout_p=0.1)
    want = jgen.PagedKVCache(page_size=4, max_len=8).attend(
        lay, jt(q), jt(k), jt(v), training=True)
    got = tgen.PagedKVCache(page_size=4, max_len=8).attend(
        lay, *map(torch.from_numpy, (q, k, v)), training=True)
    close(got, want, "PagedKVCache.attend in training without dropout")
    slot = tgen.SlotPagedKVCache(1, page_size=4, max_len=16)
    prompt = np.arange(3)
    slot.assign(0, prompt)
    slot.begin_prefill(0, 3)
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 3, 2, 8)
                         .astype(np.float32))
    with pytest.raises(ValueError):
        slot.attend(lay, x, x, x, training=True, dropout_p=0.1)
    assert slot.attend(lay, x, x, x, training=False,
                       dropout_p=0.1).shape == (1, 3, 2, 8)


# -- the flash route, weights, sharding ----------------------------------

def test_flash_route_at_group_one():
    """At 128 tokens, no dropout, head_dim 128 (GPT-3-1.3B's): causal SDPA
    takes the flash route at group 1 (B1-B3 on the card; their plain
    versions here), forward and backward, against the reference's
    einsum."""
    heads, head_dim = 2, 128
    assert sdpa_route((1, 128, heads, head_dim),
                      (1, 128, heads, head_dim)) == "flash_attn"
    jm, tm = _pair(seed=4, hidden_size=heads * head_dim,
                   num_attention_heads=heads, num_hidden_layers=1,
                   **NO_DROPOUT)
    ids = _ids(1, 128, seed=9)
    jloss, jlogits = jm(jt(ids), labels=jt(ids))
    tloss, tlogits = tm(ids, labels=ids)
    close(tlogits, jlogits, f"logits at head_dim {head_dim}")
    jloss.backward()
    tloss.backward()
    close_grads(tm, jm, f"flash route, head_dim {head_dim}")


def test_weights_round_trip_and_sharding_rules(models):
    """The tied head has no parameter of its own: the word embedding
    appears once, as in the reference; every key carries both ways."""
    jm, tm = models
    arrays = arrays_of(jm)
    assert list(tm.state_dict()) == list(arrays)
    assert not any("lm_head" in k for k in arrays)
    back = pt.jax_layout(tm)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert tgpt.GPTForCausalLM.sharding_rules() == \
        jgpt.GPTForCausalLM.sharding_rules()
    cfg = tgpt.gpt3_1p3b()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size) == (2048, 24, 16, 8192)
    with torch.device("meta"):
        full = tgpt.GPTForCausalLM(cfg, device="meta")
    n = sum(p.numel() for p in full.parameters())
    assert 1.30e9 < n < 1.35e9, n
