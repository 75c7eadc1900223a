"""The port's BERT and ERNIE (``paddle_tpu_torch/models/bert.py``) against
the reference's (``paddle_tpu/models/bert.py``) on shared weights, fp32,
CPU: the encoder with a padding mask and segment ids, the classification
and pretraining heads' losses and gradients, ERNIE's shared module in
``state_dict``, the flash route of an eval forward without a mask, and
a six-step AdamW fine-tune compiled by ``jit.to_static`` against eager
(the reference's own tolerance, ``tests/test_bert_to_static.py``)."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn.functional import sdpa_route
from torch_zoo_common import (arrays_of, close, close_grads,  # noqa: F401
                              jt, npy, one_torch_thread)
from test_torch_llama import _no_reference_mesh  # noqa: F401  (C28, C48)

B, S = 2, 12
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread, _no_reference_mesh):  # noqa: F811
    yield


def _pair(jcls, tcls, cfg_kw=None, seed=0):
    paddle.seed(seed)
    jm = jcls(jbert.bert_tiny(**(cfg_kw or {})))
    tm = tcls(tbert.bert_tiny(**(cfg_kw or {})), device="cpu")
    pt.load_jax_state(tm, arrays_of(jm))
    return jm, tm


def _batch(vocab=128, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    segments = (np.arange(S)[None] >= S // 2).astype(np.int64).repeat(B, 0)
    mask = np.ones((B, S), np.int64)
    mask[1, S - 4:] = 0                           # row 1 padded
    return ids, segments, mask


def test_bert_model_matches_reference():
    jm, tm = _pair(jbert.BertModel, tbert.BertModel)
    jm.eval()
    tm.eval()
    ids, seg, mask = _batch()
    jseq, jpool = jm(jt(ids), jt(seg), attention_mask=jt(mask))
    tseq, tpool = tm(ids, seg, attention_mask=mask)
    close(tseq, jseq, "sequence output")
    close(tpool, jpool, "pooled output")
    # absent segment ids are segment 0; positions given explicitly
    pos = np.arange(S)[None].repeat(B, 0)
    close(tm(ids, position_ids=pos)[0], jm(jt(ids), position_ids=jt(pos))[0],
          "no segments, explicit positions")


@pytest.mark.parametrize("head", ["classification", "ernie"])
def test_sequence_classification_loss_and_grads(head):
    jcls, tcls = {"classification": (jbert.BertForSequenceClassification,
                                     tbert.BertForSequenceClassification),
                  "ernie": (jbert.ErnieForSequenceClassification,
                            tbert.ErnieForSequenceClassification)}[head]
    jm, tm = _pair(jcls, tcls, NO_DROPOUT, seed=1)
    ids, seg, mask = _batch(seed=1)
    labels = np.array([0, 1], np.int64)
    jloss, jlogits = jm(jt(ids), jt(seg), attention_mask=jt(mask),
                        labels=jt(labels))
    tloss, tlogits = tm(ids, seg, attention_mask=mask, labels=labels)
    close(tlogits, jlogits, f"{head} logits")
    close(tloss, jloss, f"{head} loss")
    jloss.backward()
    tloss.backward()
    close_grads(tm, jm, head)


def test_pretraining_heads_loss_and_grads():
    jm, tm = _pair(jbert.BertForPretraining, tbert.BertForPretraining,
                   NO_DROPOUT, seed=2)
    ids, seg, _ = _batch(seed=2)
    mlm = np.full((B, S), -100, np.int64)
    mlm[:, [2, 5, 9]] = ids[:, [2, 5, 9]]          # three masked positions
    nsp = np.array([1, 0], np.int64)
    jloss, jmlm, jnsp = jm(jt(ids), jt(seg), jt(mlm), jt(nsp))
    tloss, tmlm, tnsp = tm(ids, seg, mlm, nsp)
    close(tmlm, jmlm, "MLM logits (tied decoder + mlm_bias)")
    close(tnsp, jnsp, "NSP logits")
    close(tloss, jloss, "pretraining loss")
    jloss.backward()
    tloss.backward()
    close_grads(tm, jm, "pretraining")
    assert "mlm_bias" in tm.state_dict()


def test_ernie_state_dict_is_the_references_and_round_trips():
    """ERNIE registers one module as ``bert`` and ``ernie``: its
    ``state_dict`` lists it once, under ``bert.``, as the reference's
    does (41 keys at ``bert_tiny``), and weights carry both ways."""
    paddle.seed(3)
    jm = jbert.ErnieForSequenceClassification(jbert.bert_tiny())
    tm = tbert.ErnieForSequenceClassification(tbert.bert_tiny(),
                                              device="cpu", seed=3)
    assert tm.ernie is tm.bert
    keys = list(tm.state_dict())
    assert keys == list(jm.state_dict()) and len(keys) == 41
    assert not any(k.startswith("ernie.") for k in keys)
    arrays = arrays_of(jm)
    pt.load_jax_state(tm, arrays)
    back = pt.jax_layout(tm)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    cfg = tbert.ErnieConfig()
    assert (cfg.vocab_size, cfg.type_vocab_size) == (40000, 4)


def test_eval_without_mask_takes_the_flash_route():
    """At head_dim 64 and 128 tokens, eval, no mask: the port's encoder
    attention takes the flash route, non-causal (B1 on the card, its
    plain version here), the reference's CPU einsum the same values."""
    kw = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=128)
    assert sdpa_route((1, 128, 2, 64), (1, 128, 2, 64)) == "flash_attn"
    jm, tm = _pair(jbert.BertModel, tbert.BertModel, kw, seed=4)
    jm.eval()
    tm.eval()
    ids = np.random.RandomState(4).randint(0, 128, (1, 128))
    jseq, jpool = jm(jt(ids))
    tseq, tpool = tm(ids)
    close(tseq, jseq, "sequence output at seq 128")
    close(tpool, jpool, "pooled output at seq 128")


def _finetune(model, ids, labels, mask, steps=6):
    opt = pt.optimizer.AdamW(learning_rate=5e-4,
                             parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss, _ = model(ids, attention_mask=mask, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def test_finetune_to_static_matches_eager_and_reference():
    """Six AdamW steps on a half-padded batch: compiled (``jit.to_static``,
    no graph break) against eager within the reference test's rtol 2e-4,
    atol 2e-5, and eager against the reference's eager steps."""
    cfg = dict(vocab_size=128)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (8, 32))
    labels = rng.integers(0, 2, (8,))
    mask = np.ones((8, 32), np.int64)
    mask[:, 16:] = 0
    paddle.seed(3)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(**cfg))
    arrays = arrays_of(jm)
    jm.eval()
    jopt = paddle.optimizer.AdamW(learning_rate=5e-4,
                                  parameters=jm.parameters())
    want = []
    for _ in range(6):
        loss, _ = jm(jt(ids), attention_mask=jt(mask), labels=jt(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(np.asarray(loss._data)))
    runs = {}
    for name in ("eager", "static"):
        tm = pt.load_jax_state(tbert.BertForSequenceClassification(
            tbert.bert_tiny(**cfg), device="cpu"), arrays)
        tm.eval()
        if name == "static":
            pt.jit.to_static(tm, backend="aot_eager", full_graph=True)
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            runs[name] = _finetune(tm, torch.from_numpy(ids),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(runs["static"], runs["eager"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(runs["eager"], want, rtol=2e-4, atol=2e-5)
    assert runs["static"][-1] < runs["static"][0], runs["static"]


def test_seeded_build_and_device():
    a = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu", seed=5)
    b = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu", seed=5)
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    w = a.bert.embeddings.word_embeddings.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.003
    assert torch.equal(a.bert.embeddings.layer_norm.weight.detach(),
                       torch.ones(64))
    assert not a.mlm_bias.detach().any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tbert.BertModel(tbert.bert_tiny())
